"""HSTU generative-recommendation backbone in PyTorch (port of
``repro.models.hstu``) — the GR model family served by RelayGR.

    U, V, Q, K = split(SiLU(f1(norm(x))))
    A          = SiLU(Q K^T / sqrt(d)) / n        (no softmax)
    y          = x + f2(norm(A V) * U)

The per-layer (K, V) of the user-behaviour prefix is psi(u), the object
RelayGR pre-infers and relays.  Public tensors keep JAX's layouts: psi
is a ``(K, V)`` pair of ``(L, B, P, H, D)`` tensors, parameters keep the
shapes of ``repro``'s parameter tree (``models/convert.py`` moves one
into the other).

Attention goes through ``repro_torch.kernels.ops`` at every call site —
causal prefill and the training loss (``hstu_attn``, with a gradient
when autograd records), rank with cache and the one-token decode
(``prefix_rank_attn``), rank with pages or segments — which launch the
CUDA kernels on CUDA tensors and run the plain versions on the CPU.
The projections around attention stay ``torch.matmul``.

Parameters are created without gradients; the serving entry points run
under ``torch.no_grad`` and compute the same with gradients on or off,
and ``launch.steps.make_train_step`` turns them on for ``loss``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.kernels import ops, ref

from .arch import (StepSpecs, _embed, _logits, ce_loss, draw_params,
                   embed_specs, fsdp_cuts, global_ce, kv_seq_axis,
                   local_param_specs, own_params, ring_axis, stack_specs)
from .config import ModelConfig
from .layers import DTYPES, ParamSpec, rms_norm, rope_tables, rotate_pairs
from .partitioning import (axis_index, axis_size, checkpoint_in_rules, enter,
                           gather, local_spec_tree, psum, reduce,
                           refuse_under_mesh, sharded_axis)


def hstu_block_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, hd, dt = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.dtype
    return {
        "ln": ParamSpec((d,), ("embed",), init="ones"),
        "uvqk": ParamSpec((d, 4, h, hd), ("embed", None, "heads", None),
                          dtype=dt),
        "ln_attn": ParamSpec((h * hd,), ("heads",), init="ones"),
        "wo": ParamSpec((h, hd, d), ("heads", None, "embed"), dtype=dt),
    }


def rank_mask(n_prefix: int, n_incr: int, n_items: int, device=None):
    """(1, 1, Sq, Sk) ranking mask: queries [incr | items], keys
    [prefix | incr | items]; incr causal, items see prefix+incr+self."""
    return ref.rank_mask_ref(n_prefix, n_incr, n_items,
                             device=device)[None, None]


class HSTUModel(StepSpecs, nn.Module):
    """The RelayGR prefix/rank protocol over an HSTU stack.

    Parameters live on ``device`` from construction; ``init`` fills them
    from a ``torch.Generator`` with the reference's init rule, and
    ``convert.load_jax_params`` loads a ``repro`` parameter tree."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        # float32 products stay float32 on the card (no TF32 rounding)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.device = resolve_device(device)
        full = self.param_specs()
        specs = local_param_specs(full)

        def param(spec: ParamSpec) -> nn.Parameter:
            return nn.Parameter(torch.empty(spec.shape,
                                            dtype=DTYPES[spec.dtype],
                                            device=self.device),
                                requires_grad=False)

        for name in ("tok", "final_norm", "unembed"):
            setattr(self, name, param(specs[name]))
        self.layers = nn.ParameterDict(
            {k: param(s) for k, s in specs["layers"].items()})
        if "task_tower" in specs:
            self.task_tower = nn.ParameterDict(
                {k: param(s) for k, s in specs["task_tower"].items()})
        # the FSDP cuts that ``arch.whole`` gathers, as ``add_params``'s
        for mod, sp in ((self, full), (self.layers, full["layers"]),
                        (getattr(self, "task_tower", None),
                         full.get("task_tower"))):
            if mod is not None:
                mod._fsdp = fsdp_cuts(sp)

    def param_specs(self):
        cfg = self.cfg
        specs = dict(embed_specs(cfg))
        specs["layers"] = stack_specs(hstu_block_specs(cfg), cfg.n_layers)
        if cfg.n_tasks:
            d = cfg.d_model
            specs["task_tower"] = {
                "w1": ParamSpec((d, 4 * d), ("embed", "ff"), dtype=cfg.dtype),
                "w2": ParamSpec((4 * d, cfg.n_tasks), ("ff", None),
                                dtype=cfg.dtype),
            }
        return specs

    def init(self, generator: torch.Generator) -> "HSTUModel":
        """Draw every parameter on the CPU from ``generator`` (so the
        weights do not depend on the device), in sorted-name order
        (``arch.draw_params``: a bounded chunk at a time; under a process
        mesh the rank's shard of the full draw)."""
        return draw_params(self, generator)

    # --- core block -------------------------------------------------------
    def _block(self, l, x, rope, attend):
        """One layer.  Under a "heads"-sharded ``uvqk`` (ref hstu.py:
        96-123) the rank computes its h heads: the normed input enters
        the column-parallel ``uvqk``, ``ln_attn``'s RMS over all heads
        sums its squares over the axis, and ``wo`` leaves a partial sum,
        reduced over it.  The layer's weights are read whole
        (``arch.own_params``: gathered where FSDP cut them)."""
        cfg = self.cfg
        p = own_params(self.layers, (l,))
        d, _, h, hd = p["uvqk"].shape
        B, S, _ = x.shape
        tp = sharded_axis(h, cfg.n_heads, "heads")
        xn = rms_norm(x, p["ln"])
        if tp:
            xn = enter(xn, tp)
        uvqk = F.silu(xn @ p["uvqk"].reshape(d, 4 * h * hd))
        uvqk = uvqk.view(B, S, 4, h, hd)
        u, v, qk = uvqk[:, :, 0], uvqk[:, :, 1], uvqk[:, :, 2:]
        if rope is not None:                 # q and k rotate in one pass
            qk = rotate_pairs(qk, *rope)
        q, k = qk.unbind(2)
        av = attend(l, q, k, v)                          # (B, S, H, D)
        w = p["ln_attn"]
        w_ax = sharded_axis(w.shape[0], cfg.n_heads * cfg.head_dim, "heads")
        if w_ax and not tp:
            # heads the axis does not divide are replicated, but h * hd
            # may still split: the reference's GSPMD gathers the weight
            w = gather(w, w_ax).reshape(-1)
        av = rms_norm(av.reshape(B, S, h * hd), w, axis=tp)
        y = (av.view(B, S, h, hd) * u).reshape(B, S, h * hd) \
            @ p["wo"].reshape(h * hd, d)
        # ref hstu.py:123: constrain(y, ("batch", "seq", "embed"))
        return x + (reduce(y, tp) if tp else y), (k, v)

    def _run(self, x, positions, attend, keep_kv: bool = False,
             remat: bool = False):
        """All layers over x (B, S, d) at ``positions`` (1, S) or (B, 1).
        The RoPE tables are built once here, shaped to broadcast over the
        (B, S, 2, H, D/2) pairs of q and k, and shared by every layer.
        ``remat`` runs each layer under ``torch.utils.checkpoint``: only
        its input is kept, and the backward runs it again (the
        reference's ``jax.checkpoint(..., nothing_saveable)`` around the
        scan body)."""
        rope = None
        if self.cfg.rope_theta:
            rope = tuple(t[..., None, None, :] for t in rope_tables(
                positions, self.cfg.head_dim, self.cfg.rope_theta))
        ks, vs = [], []
        for l in range(self.cfg.n_layers):
            if remat:
                x = checkpoint_in_rules(
                    lambda xc, l=l: self._block(l, xc, rope, attend)[0], x)
                continue
            x, (k, v) = self._block(l, x, rope, attend)
            if keep_kv:
                ks.append(k)
                vs.append(v)
        kv = (torch.stack(ks), torch.stack(vs)) if keep_kv else None
        return x, kv

    # --- LM-style protocol: training and one-token decode -------------------
    def loss(self, batch):
        """{"tokens": (B, S), "labels": (B, S)} -> (mean next-token CE,
        {"ce": CE}).  Causal attention over the S tokens at positions
        arange(S), every layer rematerialised, the CE chunked
        (``arch.ce_loss``).  Gradients flow to the parameters that
        require them (``launch.steps.make_train_step`` turns them on)."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        top = own_params(self)
        x = _embed(top["tok"], tokens, cfg.vocab_padded)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :]
        x, _ = self._run(
            x, positions,
            lambda l, q, k, v: ops.hstu_attention(q, k, v, n_total=S),
            remat=True)
        ce = ce_loss(top["final_norm"], top["unembed"], x, labels, cfg.vocab,
                     vp=cfg.vocab_padded)
        return ce, {"ce": global_ce(ce)}

    @torch.no_grad()
    def decode_step(self, cache, batch, seq_len=None):
        """One token per row against psi: {"token": (B, 1), "pos": (B,)}
        with ``cache`` a (K, V) pair of (L, B, P, H, D) -> (logits
        (B, 1, vocab_padded), cache).  The token attends to all P cached
        tokens and itself (n_total = P + 1, the reference's ``mask=None``
        path), rotated at its row's ``pos``; the cache is returned
        unchanged, as in the reference.

        ``seq_len`` (P) tells a psi whose tokens kv_seq shards over the
        ranks of an axis (``arch.ring_axis``): HSTU's attention is a sum
        of SiLU terms over 1 / n_total with no softmax, so each rank
        attends over its P / n tokens with the global n_total (the token
        itself on the axis's first rank only: the others give it a zero
        V) and one ``psum`` over the axis adds the parts."""
        token = torch.as_tensor(batch["token"], device=self.device).long()
        pos = torch.as_tensor(batch["pos"], device=self.device)
        pk, pv = cache
        sa = ring_axis(token.shape[0], pk.shape[2], seq_len, seq_len)
        n_total = pk.shape[2] * axis_size(sa) + 1
        vp = self.cfg.vocab_padded
        top = own_params(self)
        x = _embed(top["tok"], token, vp)

        def attend(l, q, k, v):
            if sa and axis_index(sa):
                v = torch.zeros_like(v)
            av = ops.rank_attention(q, k, v, pk[l], pv[l], n_incr=1,
                                    n_total=n_total)
            return psum(av, sa) if sa else av

        x, _ = self._run(x, pos[:, None], attend)
        return _logits(top["final_norm"], top["unembed"], x, vp), cache

    # --- RelayGR prefix / rank protocol -------------------------------------
    @torch.no_grad()
    def prefill(self, batch):
        """Pre-inference: {"tokens": (B, S)} -> (last-position logits,
        psi = per-layer (K, V), each (L, B, S, H, D))."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        vp = self.cfg.vocab_padded
        top = own_params(self)
        x = _embed(top["tok"], tokens.long(), vp)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :]
        x, kv = self._run(
            x, positions,
            lambda l, q, k, v: ops.hstu_attention(q, k, v, n_total=S),
            keep_kv=True)
        return _logits(top["final_norm"], top["unembed"], x[:, -1:], vp), kv

    def _rank(self, incr_tokens, item_tokens, n_prefix: int, attend_for):
        n_incr = incr_tokens.shape[1]
        x = _embed(own_params(self, names=("tok",))["tok"],
                   torch.cat([incr_tokens, item_tokens], dim=1).long(),
                   self.cfg.vocab_padded)
        Sq = x.shape[1]
        positions = (n_prefix + torch.arange(Sq, device=x.device))[None, :]
        x, _ = self._run(x, positions,
                         attend_for(n_incr=n_incr, n_total=n_prefix + Sq))
        items_h = x[:, n_incr:]
        tw = own_params(self.task_tower)
        tp = sharded_axis(tw["w1"].shape[1], 4 * self.cfg.d_model, "ff")
        if tp:
            items_h = enter(items_h, tp)
        scores = F.silu(items_h @ tw["w1"]) @ tw["w2"]
        return reduce(scores, tp) if tp else scores

    @torch.no_grad()
    def rank_with_cache(self, cache: Optional[Tuple], incr_tokens,
                        item_tokens):
        """Score candidate items reusing the cached prefix psi, a (K, V)
        pair of (L, B, P, H, D) — or None for no prefix.  Returns scores
        (B, n_items, n_tasks)."""
        cfg = self.cfg
        if cache is None:
            B = incr_tokens.shape[0]
            z = torch.zeros((cfg.n_layers, B, 0, self.layers["uvqk"].shape[3],
                             cfg.head_dim),
                            dtype=DTYPES[cfg.dtype], device=self.device)
            cache = (z, z)
        pk, pv = cache

        def attend_for(n_incr, n_total):
            return lambda l, q, k, v: ops.rank_attention(
                q, k, v, pk[l], pv[l], n_incr=n_incr, n_total=n_total)

        return self._rank(incr_tokens, item_tokens, pk.shape[2], attend_for)

    @torch.no_grad()
    def rank_with_pages(self, pool, tables, prefix_lens, incr_tokens,
                        item_tokens):
        """Score candidates with psi read straight from the page pool.

        pool:        (N + 1, page_tokens, H, D), last row the null page
        tables:      (B, L, 2, n_pages) int32 — [:, l, 0] layer l's K
                     pages, [:, l, 1] its V pages (null-page padded)
        prefix_lens: (B,) int32 resident psi tokens per row

        The prefix spans ``n_pages * page_tokens`` positions, exactly
        the padded psi length the dense path ranks against.  Not under a
        process mesh: the relay runs it per instance."""
        refuse_under_mesh("rank_with_pages", "the relay runs it per "
                          "instance, never under a mesh")
        n_prefix = tables.shape[-1] * pool.shape[1]

        def attend_for(n_incr, n_total):
            return lambda l, q, k, v: ops.paged_rank_attention(
                q, k, v, pool, tables[:, l, 0], tables[:, l, 1],
                prefix_lens, n_incr=n_incr, n_total=n_total)

        return self._rank(incr_tokens, item_tokens, n_prefix, attend_for)

    @torch.no_grad()
    def rank_with_segments(self, pool, tables, page_pos, page_valid,
                           incr_tokens, item_tokens):
        """Score candidates with psi read from cached spans in the pool.

        pool, tables: as ``rank_with_pages``; the tables name each row's
                      span pages in order
        page_pos:     (B, n_pages) int32 global position of each page's
                      first token
        page_valid:   (B, n_pages) int32 tokens each page holds (0 on
                      padded slots and pages not resident)

        Positions and normalizer are ``rank_with_pages``'s, as in the
        reference's rank: the fresh tokens sit at ``n_pages *
        page_tokens + arange(Sq)`` (RoPE and ``q_pos`` alike), and
        n_total is ``n_pages * page_tokens + Sq``.  Not under a process
        mesh: the relay runs it per instance."""
        refuse_under_mesh("rank_with_segments", "the relay runs it per "
                          "instance, never under a mesh")
        n_prefix = tables.shape[-1] * pool.shape[1]
        B = incr_tokens.shape[0]
        Sq = incr_tokens.shape[1] + item_tokens.shape[1]
        q_pos = torch.arange(n_prefix, n_prefix + Sq, dtype=torch.int32,
                             device=pool.device).expand(B, Sq)

        def attend_for(n_incr, n_total):
            return lambda l, q, k, v: ops.segment_rank_attention(
                q, k, v, pool, tables[:, l, 0], tables[:, l, 1], page_pos,
                page_valid, q_pos, n_items=Sq - n_incr, n_total=n_total)

        return self._rank(incr_tokens, item_tokens, n_prefix, attend_for)

    @torch.no_grad()
    def full_rank(self, prefix_tokens, incr_tokens, item_tokens):
        """Baseline: full inference with the long prefix on the critical
        path (no cache)."""
        _, kv = self.prefill({"tokens": prefix_tokens})
        return self.rank_with_cache(kv, incr_tokens, item_tokens)

    def cache_specs(self, batch: int, seq_len: int):
        """((K, V) (shape, dtype)), (K, V) logical axes) of psi."""
        cfg = self.cfg
        kv = ((cfg.n_layers, batch, seq_len, cfg.n_heads, cfg.head_dim),
              DTYPES[cfg.dtype])
        return (kv, kv), self.cache_axes(batch, seq_len)

    def cache_axes(self, batch: int, seq_len: int):
        """The logical axes of psi's (K, V)."""
        axes = ("layers", "batch", kv_seq_axis(batch, seq_len), "heads", None)
        return (axes, axes)

    def init_cache(self, batch: int, seq_len: int):
        """A zero psi of ``seq_len`` tokens: (K, V), each (L, B, S, H, D)
        (under a process mesh this rank's shard)."""
        specs, axes = self.cache_specs(batch, seq_len)
        return tuple(torch.zeros(kv[0], dtype=kv[1], device=self.device)
                     for kv in local_spec_tree(specs, axes))

    def kv_bytes(self, seq_len: int) -> int:
        """psi footprint per user — drives trigger admission control."""
        specs, _ = self.cache_specs(1, seq_len)
        total = 0
        for shape, dtype in specs:
            n = 1
            for s in shape:
                n *= s
            total += n * torch.empty((), dtype=dtype).element_size()
        return total
