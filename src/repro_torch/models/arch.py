"""Architecture assembly, in PyTorch (port of ``repro.models.arch``).

The embedding / unembedding, the chunked training loss and the layer
stacking shared by the families, the decoder-only Transformer (dense,
MoE and VLM: ``TransformerModel``), the attention-free SSM stacks
(RWKV6 and Mamba2: ``SSMModel``) and the Zamba2 hybrid
(``HybridModel``).  The encoder-decoder is ``models/encdec.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch import nn

from repro_torch import resolve_device

from . import ssm as ssm_lib
from .config import InputShape, ModelConfig
from .layers import (DTYPES, ParamSpec, abstract_tree, attention,
                     attention_specs, axes_tree, cross_entropy, ffn,
                     ffn_specs, rms_norm)
from .moe import moe_aux, moe_ffn, moe_specs, shared_expert_ffn
from .partitioning import (active_axes, axis_index, axis_size, batch_axis,
                           checkpoint_in_rules, current_rules, enter,
                           fsdp_cut, gather_dim, is_process_mesh,
                           local_shape, local_spec_tree, pmax, psum, reduce,
                           shard_slices, sharded_axis)


def stack_specs(specs, n: int):
    """Add a leading stacked-layer dim to every ParamSpec of a tree."""
    if isinstance(specs, ParamSpec):
        return dataclasses.replace(specs, shape=(n,) + specs.shape,
                                   axes=("layers",) + specs.axes)
    return {k: stack_specs(s, n) for k, s in specs.items()}


def embed_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, vp, dt = cfg.d_model, cfg.vocab_padded, cfg.dtype
    return {
        "tok": ParamSpec((vp, d), ("vocab", "embed"), scale=1.0, dtype=dt),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "unembed": ParamSpec((d, vp), ("embed", "vocab"), dtype=dt),
    }


def _embed(tok, tokens, vp: int = None):
    """The rows of ``tok`` (vp rows in all) at ``tokens``.  Under a
    vocab-sharded ``tok`` (the reference's ("vocab", "embed") weight) a
    rank holds rows [v0, v0 + Vl): it looks up the tokens in its range,
    zeros the others, and the sum over "model" gives every rank the
    whole embedding (one rank's row plus zeros: exact).  ``vp`` None:
    ``tok`` is whole."""
    ax = sharded_axis(tok.shape[0], vp, "vocab") if vp else None
    if ax is None:
        return tok[tokens]
    vl = tok.shape[0]
    t = tokens - axis_index(ax) * vl
    mine = (t >= 0) & (t < vl)
    e = torch.where(mine[..., None], tok[t.clamp(0, vl - 1)], 0)
    # ref arch.py:57: constrain(e, ("batch", "seq", "embed"))
    return reduce(e, ax)


def _logits(final_norm, unembed, x, vp: int = None):
    """Logits (..., vp), or under a vocab-sharded ``unembed`` this
    rank's columns (ref arch.py:63: constrain(lg, ("batch", "seq",
    "vocab")))."""
    xn = rms_norm(x, final_norm)
    ax = sharded_axis(unembed.shape[1], vp, "vocab") if vp else None
    return (enter(xn, ax) if ax else xn) @ unembed


def vocab_parallel_ce(logits, labels, vocab: int, ax):
    """``layers.cross_entropy`` of logits whose last dimension is this
    rank's columns of the vocabulary on mesh axis ``ax``: the row max
    (``pmax``), the sum of exponentials and the label's logit (each
    ``reduce``) are one all-reduce each over ``ax``; the padded ids
    (>= vocab) are masked on whichever rank holds them."""
    vl = logits.shape[-1]
    v0 = axis_index(ax) * vl
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    vid = v0 + torch.arange(vl, device=logits.device)
    logits = torch.where(vid < vocab, logits, -1e30)
    m = pmax(logits.detach().amax(dim=-1), ax)
    se = reduce((logits - m[..., None]).exp().sum(dim=-1), ax)
    t = labels.long() - v0
    mine = (t >= 0) & (t < vl)
    gold = torch.where(mine, logits.gather(
        -1, t.clamp(0, vl - 1)[..., None])[..., 0], 0.0)
    return m + se.log() - reduce(gold, ax)


CE_CHUNK = 512


def ce_loss(final_norm, unembed, x, labels, vocab: int,
            chunk: int = CE_CHUNK, vp: int = None):
    """Sequence-chunked cross-entropy: the (B, S, vocab_padded) logits
    are the largest training temporary (1.64 GB f32 per 512-token chunk
    at B 8 for hstu-gr), so each chunk's logits are computed under a
    ``torch.utils.checkpoint`` and only one (B, chunk, Vp) slice is
    alive at a time, in the backward too.  The same value as the
    unchunked mean (sum / (B S)); S <= chunk or S % chunk != 0 computes
    it unchunked.

    Under a process mesh ``x`` holds this rank's rows of the batch: the
    result is their share of the global mean (their sum over the global
    count), which ``psum`` over the batch axes makes whole; the CE is
    vocab-parallel where ``unembed`` is vocab-sharded."""
    B, S, _ = x.shape
    ax = sharded_axis(unembed.shape[1], vp, "vocab") if vp else None

    def ce(xx, ll):
        lg = _logits(final_norm, unembed, xx, vp)
        return (vocab_parallel_ce(lg, ll, vocab, ax) if ax
                else cross_entropy(lg, ll, vocab))

    n = B * S * axis_size(batch_axis())
    if S <= chunk or S % chunk:
        return ce(x, labels).sum() / n if n != B * S else ce(x, labels).mean()

    def one(xx, ll):
        return ce(xx, ll).sum()

    tot = sum(checkpoint_in_rules(one, x[:, i:i + chunk],
                                  labels[:, i:i + chunk])
              for i in range(0, S, chunk))
    return tot / n


def global_ce(ce):
    """The step's CE metric: a rank's share (``ce_loss``) summed over
    the batch axes (a new, detached tensor); ``ce`` itself off a mesh
    that shards the batch."""
    return psum(ce, batch_axis())


def flat_specs(specs, prefix: str = "") -> Dict[str, ParamSpec]:
    """A spec tree flattened to ``state_dict`` names."""
    out = {}
    for k, s in specs.items():
        if isinstance(s, ParamSpec):
            out[prefix + k] = s
        else:
            out.update(flat_specs(s, f"{prefix}{k}."))
    return out


def add_params(module: nn.Module, specs, device):
    """Lay ``specs`` (global shapes) out on ``module``: a leaf becomes a
    parameter holding this rank's shard (``local_param_specs``), a dict
    a ``ParamTree`` submodule, each named by its key — so
    ``state_dict`` names are the reference tree's paths
    (``sections.mixer.w_in``).  The leaves' FSDP cuts go to
    ``module._fsdp`` (``fsdp_cuts``), which ``whole`` reads."""
    module._fsdp = fsdp_cuts(specs)
    for k, s in specs.items():
        if isinstance(s, ParamSpec):
            s = local_param_specs(s)
            module.register_parameter(k, nn.Parameter(
                torch.empty(s.shape, dtype=DTYPES[s.dtype], device=device),
                requires_grad=False))
        else:
            module.add_module(k, ParamTree(s, device))


def fsdp_cuts(specs) -> Dict[str, tuple]:
    """{name: (dimension, mesh axis)} of the leaves of ``specs`` (one
    level, global shapes) whose "embed" dimension the current rules of
    a process mesh shard (``partitioning.fsdp_cut``: FSDP)."""
    rules = current_rules()
    if rules is None or not is_process_mesh(rules.mesh):
        return {}
    cuts = {k: fsdp_cut(s.axes, s.shape, rules) for k, s in specs.items()
            if isinstance(s, ParamSpec)}
    return {k: c for k, c in cuts.items() if c is not None}


def whole(module: nn.Module, name: str, idx=()):
    """``module``'s parameter ``name``, indexed by ``idx`` (its leading
    stacked dimensions), whole: where FSDP cut its "embed" dimension
    (``module._fsdp``) the shards are gathered over that axis, and the
    gradient is reduce-scattered (``gather_dim(partial=True)``: each
    data rank's gradient of the whole weight covers its own rows of the
    batch).  The one gather point of the model code: a layer reads its
    weights through it inside its checkpoint, so that the recompute
    gathers them again and no whole layer stays resident (ZeRO-3)."""
    p = module._parameters[name]
    t = p[idx] if idx else p
    cut = module._fsdp.get(name)
    if cut is None:
        return t
    return gather_dim(t, cut[1], cut[0] - len(idx), partial=True)


def own_params(module: nn.Module, idx=(), names=None
               ) -> Dict[str, torch.Tensor]:
    """``whole`` of each parameter of ``module`` itself (not of its
    submodules; ``names``: of those alone): a model's top-level weights,
    gathered once a step."""
    return {k: whole(module, k, idx) for k in names or module._parameters}


def local_param_specs(specs):
    """``specs`` as this rank's shards under the current rules (each
    sharded dimension divided: ``partitioning.local_shape``); the specs
    themselves outside a process mesh."""
    rules = current_rules()
    if rules is None or not is_process_mesh(rules.mesh):
        return specs
    if isinstance(specs, ParamSpec):
        return dataclasses.replace(specs, shape=local_shape(
            specs.shape, rules.spec(specs.axes, shape=specs.shape),
            rules.mesh))
    return {k: local_param_specs(s) for k, s in specs.items()}


class ParamTree(nn.Module):
    """A subtree of parameters (see ``add_params``)."""

    def __init__(self, specs, device):
        super().__init__()
        add_params(self, specs, device)

    def tree(self, *idx):
        """The subtree as nested dicts of tensors, each indexed by
        ``idx`` (a view: one layer of a stack) and whole (``whole``:
        gathered where FSDP cut it)."""
        out = own_params(self, idx)
        out.update({k: m.tree(*idx) for k, m in self._modules.items()})
        return out


# the most elements one draw holds on the host (64 MB of float32)
DRAW_CHUNK = 1 << 24


def draw_into(spec: ParamSpec, dst, generator: torch.Generator,
              slices=None):
    """Fill ``dst`` with ``spec.initialise(generator)[slices]`` (the
    whole tensor without ``slices``), drawing the full tensor in flat
    chunks of at most DRAW_CHUNK elements, whole rows of its trailing
    dimensions each, so that the host holds one chunk at a time.

    A CPU ``torch.randn`` of n elements equals consecutive draws of its
    parts when every part but the last is a multiple of 16 elements and
    the last has at least 16 (it fills 16 at a time and redraws the
    last 16 of a ragged tail), so the chunks keep the stacked draw's
    numbers bit for bit.  Every chunk is drawn, on every rank, and each
    keeps the rows and columns of its shard."""
    shape = tuple(spec.shape)
    slices = slices or tuple(slice(0, n) for n in shape)
    dt = DTYPES[spec.dtype]
    if spec.init != "normal":
        dst.copy_(spec.initialise(generator)[slices])
        return
    n = 1
    for v in shape:
        n *= v
    j = 0                      # rows: the trailing dims [j:] fit a chunk
    while j < len(shape) and n > DRAW_CHUNK:
        n //= shape[j]
        j += 1
    if j == 0:
        dst.copy_(spec.initialise(generator)[slices])
        return
    unit = 16 // math.gcd(n, 16)                 # rows a chunk is made of
    per = max(DRAW_CHUNK // n // unit, 1) * unit
    lead = shape[:j]
    rows_total = math.prod(lead)
    lo = torch.tensor([s.start for s in slices[:j]])
    hi = torch.tensor([s.stop for s in slices[:j]])
    local_lead = (hi - lo).tolist()
    out = dst.view((-1,) + tuple(dst.shape[j:]))
    starts = list(range(0, rows_total, per))
    if len(starts) > 1 and (rows_total - starts[-1]) * n < 16:
        starts.pop()                             # a tail of >= 16 elements
    for i, r0 in enumerate(starts):
        r1 = starts[i + 1] if i + 1 < len(starts) else rows_total
        x = torch.randn((r1 - r0) * n, generator=generator,
                        dtype=torch.float32)
        x = (x.view((r1 - r0,) + shape[j:]) * spec.std).to(dt)
        if local_lead == list(lead):             # every row is this rank's
            out[r0:r1].copy_(x[(slice(None),) + tuple(slices[j:])])
            continue
        rows = torch.arange(r0, r1)
        idx, rest = [], rows
        for size in reversed(lead):
            idx.append(rest % size)
            rest = rest // size
        idx = torch.stack(idx[::-1], dim=1)                   # (rows, j)
        keep = ((idx >= lo) & (idx < hi)).all(dim=1)
        if not keep.any():
            continue
        local = torch.zeros_like(rows)
        for d in range(j):
            local = local * local_lead[d] + (idx[:, d] - lo[d])
        out[local[keep]] = x[keep][(slice(None),) + tuple(slices[j:])].to(
            out.device)


def draw_params(model: nn.Module, generator: torch.Generator):
    """Fill every parameter of ``model`` (laid out by ``add_params`` from
    ``model.param_specs()``) on the CPU from ``generator`` (so the
    weights do not depend on the device), in sorted-name order, a
    bounded chunk at a time (``draw_into``).  Under a process mesh
    every rank draws the full weights, as one device does, and keeps
    its shard."""
    params = dict(model.named_parameters())
    specs = flat_specs(model.param_specs())
    rules = current_rules()
    sharded = rules is not None and is_process_mesh(rules.mesh)
    with torch.no_grad():
        for name in sorted(specs):
            s = specs[name]
            sl = (shard_slices(s.shape, rules.spec(s.axes, shape=s.shape),
                               rules.mesh) if sharded else None)
            draw_into(s, params[name], generator, sl)
    return model


def zero_cache(model, batch_local: int, seq_len: int = 0):
    """``model.init_cache`` for this rank's ``batch_local`` rows: the
    zero state a loss or a prefill starts from (``init_cache`` takes the
    global batch, which the batch axes shard)."""
    return model.init_cache(batch_local * axis_size(batch_axis()), seq_len)


def zeros_from_specs(spec, device):
    """A tree of (shape, dtype) leaves (dicts and tuples) as zeros."""
    if isinstance(spec, dict):
        return {k: zeros_from_specs(v, device) for k, v in spec.items()}
    if isinstance(spec[1], torch.dtype):
        return torch.zeros(spec[0], dtype=spec[1], device=device)
    return tuple(zeros_from_specs(s, device) for s in spec)


def base_batch_specs(shape: InputShape):
    """The reference's ``BaseModel.batch_specs``: an entry point's batch
    as {name: (shape, dtype)}."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": ((B, S), torch.int32),
                "labels": ((B, S), torch.int32)}
    if shape.kind == "prefill":
        return {"tokens": ((B, S), torch.int32)}
    return {"token": ((B, 1), torch.int32), "pos": ((B,), torch.int32)}


def base_batch_axes(shape: InputShape):
    """The logical axes of ``base_batch_specs``' entries (the
    reference's ``BaseModel.batch_axes``)."""
    if shape.kind == "train":
        return {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if shape.kind == "prefill":
        return {"tokens": ("batch", "seq")}
    return {"token": ("batch", None), "pos": ("batch",)}


def kv_seq_axis(batch: int, seq_len: int):
    """A K/V cache's sequence axis: "kv_seq" (sharded over "data" by the
    dry-run's long-context rule) for one sequence of 65536 or more
    tokens, else None — the reference's rule in every family."""
    return "kv_seq" if (batch == 1 and seq_len >= 65536) else None


def ring_axis(batch_local: int, ring_local: int, ring: int, seq_len):
    """The mesh axis that shards a decode ring's sequence under the
    current rules ("kv_seq": the reference's dry-run maps it to "data"
    for one sequence, and ``kv_seq_axis`` names it from 65536 tokens),
    or None where this rank holds the whole ring.  ``seq_len`` is the
    decode's global length (what ``init_cache`` was given), ``ring``
    the ring it makes (shorter under a sliding window), ``ring_local``
    the slots this rank holds.  A rank's ring cannot tell a shard from
    a whole ring of that length, so under rules that map kv_seq a decode
    of one sequence without its ``seq_len`` raises."""
    rules = current_rules()
    m = rules.table.get("kv_seq") if rules is not None else None
    if not active_axes(m):
        return None
    if seq_len is None:
        if batch_local == 1:
            raise ValueError("a decode of one sequence under rules that "
                             "map kv_seq needs its seq_len (the ring may "
                             "be sharded on its sequence)")
        return None
    if ring_local == ring:
        return None
    if (batch_local != 1 or not kv_seq_axis(1, seq_len)
            or ring_local * axis_size(m) != ring):
        raise ValueError(f"a ring of {ring_local} slots on this rank is "
                         f"neither the whole {ring}-slot ring of a "
                         f"{seq_len}-token decode nor its kv_seq shard")
    return m


class StepSpecs:
    """What the dry-run reads of every family (``launch.steps.make_step``):
    the parameters' (shape, dtype) stand-ins and logical axes from
    ``param_specs()``, and the batch's, with nothing allocated.  A family
    whose batch has more entries (a VLM's frontend, an enc-dec's
    frames) extends ``batch_specs`` and ``batch_axes``."""

    def abstract_params(self):
        return abstract_tree(self.param_specs())

    def param_axes(self):
        return axes_tree(self.param_specs())

    def batch_specs(self, shape: InputShape):
        """The entry point's batch as {name: (shape, dtype)}."""
        return base_batch_specs(shape)

    def batch_axes(self, shape: InputShape):
        return base_batch_axes(shape)


def _no_tf32():
    """float32 products stay float32 on the card (no TF32 rounding)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ===========================================================================
# Dense / MoE / VLM decoder-only Transformer
# ===========================================================================


class TransformerModel(StepSpecs, nn.Module):
    """Decoder-only Transformer: dense, MoE and VLM (the vision frontend
    stubbed as ``n_frontend_tokens`` precomputed patch embeddings,
    projected into d_model and prepended to the tokens).

    Parameters live on ``device`` from construction under the reference
    tree's names (``layers.attn.wq`` stacked (n_layers, ...),
    ``layers.moe.router`` float32 in any model type, ``projector`` for
    a VLM); ``init`` fills them from a ``torch.Generator``,
    ``convert.load_jax_params`` loads a ``repro`` tree.  Public layouts
    are the reference's:

    * cache ``(k, v)``, each (n_layers, B, S, KV, D), or under
      ``kv_quant`` ``(k int8, v int8, k scales, v scales)`` with scales
      (n_layers, B, S, KV, 1) float32;
    * ``prefill({"tokens": (B, S)[, "frontend": (B, F, d)]})`` and
      ``decode_step(cache, {"token": (B, 1), "pos": (B,)})`` return
      (logits (B, 1, vocab_padded), cache);
    * ``loss({"tokens", "labels"[, "frontend"]})`` returns (CE + aux,
      {"ce", "aux"}).

    ``decode_step`` writes the new K/V into the caller's cache IN PLACE
    and returns the same tensors (the reference returns a rewritten
    copy); each layer launches ``decode_attn`` once on a CUDA model.
    ``prefill`` returns the K/V unquantized, as the reference does.
    As in the reference, the sliding window masks the prefill only: a
    decode step attends over every slot of the ring."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        _no_tf32()
        self.cfg = cfg
        self.device = resolve_device(device)
        add_params(self, self.param_specs(), self.device)

    @property
    def is_moe(self):
        return self.cfg.family == "moe"

    def block_specs(self):
        cfg = self.cfg
        d = cfg.d_model
        specs = {
            "ln1": ParamSpec((d,), ("embed",), init="ones"),
            "ln2": ParamSpec((d,), ("embed",), init="ones"),
            "attn": attention_specs(cfg),
        }
        if self.is_moe:
            specs["moe"] = moe_specs(cfg)
        else:
            specs["ffn"] = ffn_specs(cfg)
        return specs

    def param_specs(self):
        cfg = self.cfg
        specs = dict(embed_specs(cfg))
        specs["layers"] = stack_specs(self.block_specs(), cfg.n_layers)
        if cfg.family == "vlm":
            # projector from the (stubbed) vision embeddings into d_model
            specs["projector"] = ParamSpec(
                (cfg.d_model, cfg.d_model), ("embed", None), dtype=cfg.dtype)
        return specs

    def init(self, generator: torch.Generator) -> "TransformerModel":
        """Draw every parameter on the CPU from ``generator``, in
        sorted-name order."""
        return draw_params(self, generator)

    # --- blocks -------------------------------------------------------------
    def _block(self, p, x, positions, cache=None, cache_index=None,
               window=0, aux=False, seq_axis=None):
        """One layer: (x, its K/V, its MoE load-balance loss).  ``aux``
        (the loss path) asks for the loss: a float32 zero for a dense
        FFN; without it (serve) the third value is None."""
        cfg = self.cfg
        h, kvc = attention(p["attn"], rms_norm(x, p["ln1"]), cfg,
                           positions=positions, cache=cache,
                           cache_index=cache_index, window=window,
                           seq_axis=seq_axis)
        x = x + h
        xn = rms_norm(x, p["ln2"])
        aux_loss = x.new_zeros((), dtype=torch.float32) if aux else None
        if self.is_moe:
            y, routing = moe_ffn(p["moe"], xn, cfg)
            if aux:
                # before the shared experts, so that a checkpoint's
                # recompute stops ahead of their output product, whose
                # result no gradient needs (the reference's remat drops
                # it too)
                aux_loss = moe_aux(*routing, cfg)
            if cfg.n_shared_experts:
                y = y + shared_expert_ffn(p["moe"], xn, cfg)
        else:
            y = ffn(p["ffn"], xn, cfg)
        return x + y, kvc, aux_loss

    def _train_block(self, l, x, positions, window):
        """Layer l on the loss path: (x, its MoE load-balance loss, a
        float32 zero for a dense FFN)."""
        x, _, aux = self._block(self.layers.tree(l), x, positions,
                                window=window, aux=True)
        return x, aux

    def _run(self, x, positions, cache=None, cache_index=None, window=0,
             remat=False, seq_axis=None):
        """The stacked layers in turn, each a view of the stack; returns
        (x, aux, kv).  With a ``cache`` (decode) its layer slices are
        updated in place and the same tuple returned; without one
        (prefill) every layer's K/V is copied into one stacked
        (n_layers, B, S, KV, D) pair; aux is None (serve never reads
        the load-balance loss).  ``remat`` (the loss path, no cache)
        runs each layer under ``torch.utils.checkpoint`` — only its
        input is kept and the backward runs it again, the reference's
        ``jax.checkpoint(..., nothing_saveable)`` around the scan body —
        keeps no K/V (kv None) and sums the MoE's ``moe_aux`` over the
        layers into aux (a float32 zero for a dense model)."""
        L = self.cfg.n_layers
        if remat:
            aux = x.new_zeros((), dtype=torch.float32)
            for l in range(L):
                x, a = checkpoint_in_rules(self._train_block, l, x,
                                           positions, window)
                aux = aux + a
            return x, aux, None
        kv = cache
        for l in range(L):
            cl = None if cache is None else tuple(t[l] for t in cache)
            x, kvc, _ = self._block(self.layers.tree(l), x, positions,
                                    cache=cl, cache_index=cache_index,
                                    window=window, seq_axis=seq_axis)
            if cache is None:
                if kv is None:
                    kv = tuple(torch.empty((L,) + tuple(t.shape),
                                           dtype=t.dtype, device=t.device)
                               for t in kvc)
                for dst, src in zip(kv, kvc):
                    dst[l] = src
        return x, None, kv

    def _prepend_frontend(self, x, batch, projector):
        """A VLM's ``frontend`` (B, F, d), cast to the ``projector``'s
        type and projected into d_model, in front of the token
        embeddings."""
        fe = torch.as_tensor(batch["frontend"], device=self.device)
        fe = torch.einsum("bfd,de->bfe", fe.to(projector.dtype), projector)
        return torch.cat([fe.to(x.dtype), x], dim=1)

    # --- public protocol ----------------------------------------------------
    def loss(self, batch):
        """{"tokens": (B, S), "labels": (B, S)} (a VLM also takes
        "frontend" (B, F, d)) -> (CE + aux, {"ce", "aux"}): the frontend
        projected in front, positions over F + S, the sliding window,
        every layer rematerialised, the frontend's positions dropped,
        the chunked CE (``ce_loss``) plus the MoE's load-balance loss
        summed over the layers (zero for a dense model)."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        top = own_params(self)
        x = _embed(top["tok"], tokens, cfg.vocab_padded)
        if cfg.family == "vlm":
            x = self._prepend_frontend(x, batch, top["projector"])
        positions = torch.arange(x.shape[1], device=self.device)[None, :]
        x, aux, _ = self._run(x, positions, window=cfg.sliding_window,
                              remat=True)
        if cfg.family == "vlm":
            x = x[:, cfg.n_frontend_tokens:]
        ce = ce_loss(top["final_norm"], top["unembed"], x, labels, cfg.vocab,
                     vp=cfg.vocab_padded)
        return ce + aux, {"ce": global_ce(ce), "aux": aux}

    @torch.no_grad()
    def prefill(self, batch):
        """{"tokens": (B, S)} (a VLM also takes "frontend" (B, F, d),
        cast to the model's type) -> (last-position logits, cache); the
        frontend's F positions come first, positions run over F + S."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        top = own_params(self)
        x = _embed(top["tok"], tokens, cfg.vocab_padded)
        if cfg.family == "vlm" and "frontend" in batch:
            x = self._prepend_frontend(x, batch, top["projector"])
        positions = torch.arange(x.shape[1], device=self.device)[None, :]
        x, _, kv = self._run(x, positions, window=cfg.sliding_window)
        return _logits(top["final_norm"], top["unembed"], x[:, -1:],
                       cfg.vocab_padded), kv

    @torch.no_grad()
    def decode_step(self, cache, batch, seq_len=None):
        """One token per sequence: {"token": (B, 1), "pos": (B,)} against
        ``cache`` -> (logits (B, 1, Vp), the same cache, updated).
        ``seq_len``: the decode's global length (``init_cache``'s), which
        tells a ring sharded on its sequence ("kv_seq") from a whole one
        (``ring_axis``)."""
        token = torch.as_tensor(batch["token"], device=self.device).long()
        pos = torch.as_tensor(batch["pos"], device=self.device)
        ring = self.cache_specs(1, seq_len)[0][0][2] if seq_len else None
        sa = ring_axis(token.shape[0], cache[0].shape[2], ring, seq_len)
        top = own_params(self)
        x = _embed(top["tok"], token, self.cfg.vocab_padded)
        x, _, cache = self._run(x, pos[:, None], cache=tuple(cache),
                                cache_index=pos, seq_axis=sa)
        return _logits(top["final_norm"], top["unembed"], x,
                       self.cfg.vocab_padded), cache

    def cache_specs(self, batch: int, seq_len: int):
        """The cache's (shape, dtype) tuple (no sharding axes): a ring of
        ``min(seq_len, sliding_window)`` slots (``seq_len`` without a
        window); int8 K/V and float32 scales under ``kv_quant``."""
        cfg = self.cfg
        S = min(seq_len, cfg.sliding_window) if cfg.sliding_window \
            else seq_len
        shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)
        if cfg.kv_quant:
            kv = (shape, torch.int8)
            sc = (shape[:-1] + (1,), torch.float32)
            return (kv, kv, sc, sc)
        kv = (shape, DTYPES[cfg.dtype])
        return (kv, kv)

    def cache_axes(self, batch: int, seq_len: int):
        """The logical axes of ``cache_specs``' leaves."""
        axes = ("layers", "batch", kv_seq_axis(batch, seq_len), "kv_heads",
                None)
        return (axes,) * (4 if self.cfg.kv_quant else 2)

    def init_cache(self, batch: int, seq_len: int):
        """Zeros of ``cache_specs`` (the reference's ``init_cache`` takes
        the unquantized layout only; here the int8 one too, with zero
        scales); under a process mesh this rank's shard of the global
        ``batch`` rows (and of the ring's slots where kv_seq shards
        them)."""
        return zeros_from_specs(local_spec_tree(
            self.cache_specs(batch, seq_len),
            self.cache_axes(batch, seq_len)), self.device)

    def batch_specs(self, shape: InputShape):
        """The entry point's batch as {name: (shape, dtype)}."""
        specs = base_batch_specs(shape)
        if self.cfg.family == "vlm" and shape.kind != "decode":
            specs["frontend"] = ((shape.global_batch,
                                  self.cfg.n_frontend_tokens,
                                  self.cfg.d_model), DTYPES[self.cfg.dtype])
        return specs

    def batch_axes(self, shape: InputShape):
        axes = base_batch_axes(shape)
        if self.cfg.family == "vlm" and shape.kind != "decode":
            axes["frontend"] = ("batch", "frames", "embed")
        return axes


# ===========================================================================
# SSM stacks (Mamba2 / RWKV6)
# ===========================================================================


class SSMModel(StepSpecs, nn.Module):
    """Attention-free stack (``ssm_rwkv6`` or ``ssm_mamba2``): each
    block is ln1 -> mixer -> residual, ln2 -> FFN -> residual; the
    decode state is O(1) in the sequence length.

    Parameters live on ``device`` from construction under the reference
    tree's names (``layers.mixer.mu``, stacked (n_layers, ...));
    ``init`` fills them from a ``torch.Generator``,
    ``convert.load_jax_params`` loads a ``repro`` tree.  Public layouts
    are the reference's:

    * state, each leaf stacked (n_layers, ...): RWKV6 ``(wkv (L, B, H,
      64, 64) float32, shift (L, B, 1, d))``, Mamba2 ``(ssm (L, B, H, N,
      P) float32, conv (L, B, K-1, C))``;
    * ``prefill({"tokens": (B, S)})`` and
      ``decode_step(state, {"token": (B, 1), "pos": (B,)})`` return
      (logits (B, 1, vocab_padded), new state);
    * ``loss({"tokens", "labels"})`` returns (CE, {"ce"}).

    ``decode_step`` returns new state tensors and leaves the caller's
    as they were (``make_serve_step``'s graph copies them back).  The
    Mamba2 prefill launches ``ssd_chunk_intra`` and ``ssd_chunk_state``
    once a layer on a CUDA model; RWKV6 reaches no kernel (its WKV scan
    is plain PyTorch, as in the reference)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        _no_tf32()
        self.cfg = cfg
        self.device = resolve_device(device)
        add_params(self, self.param_specs(), self.device)

    @property
    def is_mamba(self):
        return self.cfg.family == "ssm_mamba2"

    def block_specs(self):
        cfg = self.cfg
        d = cfg.d_model
        mixer = (ssm_lib.mamba2_specs(cfg) if self.is_mamba
                 else ssm_lib.rwkv6_specs(cfg))
        return {
            "ln1": ParamSpec((d,), ("embed",), init="ones"),
            "ln2": ParamSpec((d,), ("embed",), init="ones"),
            "mixer": mixer,
            "ffn": ffn_specs(cfg),
        }

    def param_specs(self):
        specs = dict(embed_specs(self.cfg))
        specs["layers"] = stack_specs(self.block_specs(), self.cfg.n_layers)
        return specs

    def init(self, generator: torch.Generator) -> "SSMModel":
        """Draw every parameter on the CPU from ``generator``, in
        sorted-name order."""
        return draw_params(self, generator)

    def _mix(self, p, x, state, decode):
        cfg = self.cfg
        if self.is_mamba:
            fwd = ssm_lib.mamba2_decode if decode else ssm_lib.mamba2_forward
            return fwd(p, x, cfg, state)
        return ssm_lib.rwkv6_forward(p, x, cfg, state)

    def _block(self, pl, x, state, decode):
        h, s2 = self._mix(pl["mixer"], rms_norm(x, pl["ln1"]), state, decode)
        x = x + h
        return x + ffn(pl["ffn"], rms_norm(x, pl["ln2"]), self.cfg), s2

    def _train_block(self, l, x, state):
        return self._block(self.layers.tree(l), x, state, False)[0]

    def _run(self, x, state, decode=False, remat=False):
        """The stacked layers in turn, layer l with (state[0][l],
        state[1][l]); returns x and the new state, stacked.  ``remat``
        (the loss path) runs each layer under ``torch.utils.checkpoint``
        (the reference's ``jax.checkpoint`` around the scan body) and
        returns x and no state (None)."""
        new = ([], [])
        for l in range(self.cfg.n_layers):
            sl = (state[0][l], state[1][l])
            if remat:
                x = checkpoint_in_rules(self._train_block, l, x, sl)
                continue
            x, s2 = self._block(self.layers.tree(l), x, sl, decode)
            for acc, t in zip(new, s2):
                acc.append(t)
        if remat:
            return x, None
        return x, tuple(torch.stack(t) for t in new)

    # --- public protocol ----------------------------------------------------
    def loss(self, batch):
        """{"tokens": (B, S), "labels": (B, S)} -> (CE, {"ce"}): every
        layer rematerialised from the zero state, the chunked CE.  A
        Mamba2 layer launches ``ssd_chunk_intra`` and ``ssd_chunk_state``
        in its forward and again in its recompute on a CUDA model (their
        backward launches none); RWKV6's WKV loop is plain PyTorch."""
        vp = self.cfg.vocab_padded
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        top = own_params(self)
        x = _embed(top["tok"], tokens, vp)
        x, _ = self._run(x, zero_cache(self, x.shape[0]), remat=True)
        ce = ce_loss(top["final_norm"], top["unembed"], x, labels,
                     self.cfg.vocab, vp=vp)
        return ce, {"ce": global_ce(ce)}

    @torch.no_grad()
    def prefill(self, batch):
        """{"tokens": (B, S)} -> (last-position logits, state), from a
        zero state."""
        vp = self.cfg.vocab_padded
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        top = own_params(self)
        x = _embed(top["tok"], tokens, vp)
        x, state = self._run(x, zero_cache(self, x.shape[0]))
        return _logits(top["final_norm"], top["unembed"], x[:, -1:],
                       vp), state

    @torch.no_grad()
    def decode_step(self, cache, batch, seq_len=None):
        """One token per sequence: {"token": (B, 1), "pos": (B,)} (``pos``
        unused: the state carries the position) against ``cache`` ->
        (logits (B, 1, Vp), new state).  ``seq_len`` is unused: the
        state has no sequence axis."""
        vp = self.cfg.vocab_padded
        token = torch.as_tensor(batch["token"], device=self.device).long()
        top = own_params(self)
        x = _embed(top["tok"], token, vp)
        x, state = self._run(x, cache, decode=True)
        return _logits(top["final_norm"], top["unembed"], x, vp), state

    def cache_specs(self, batch: int, seq_len: int):
        """The state's (shape, dtype) tuple (no sharding axes); it does
        not depend on ``seq_len``."""
        cfg = self.cfg
        per = (ssm_lib.mamba2_state_specs(cfg, batch) if self.is_mamba
               else ssm_lib.rwkv6_state_specs(cfg, batch))
        return tuple(((cfg.n_layers,) + shape, dt) for shape, dt in per)

    def cache_axes(self, batch: int, seq_len: int):
        """The logical axes of ``cache_specs``' leaves."""
        per = (ssm_lib.mamba2_state_axes() if self.is_mamba
               else ssm_lib.rwkv6_state_axes())
        return tuple(("layers",) + a for a in per)

    def init_cache(self, batch: int, seq_len: int):
        """Zeros of ``cache_specs``; under a process mesh this rank's
        shard (its rows of the global ``batch``, its heads)."""
        return zeros_from_specs(local_spec_tree(
            self.cache_specs(batch, seq_len),
            self.cache_axes(batch, seq_len)), self.device)


# ===========================================================================
# Hybrid (Zamba2): mamba2 backbone + shared attention blocks
# ===========================================================================


class HybridModel(StepSpecs, nn.Module):
    """``n_layers`` Mamba2 blocks; a *shared-weight* GQA block (with a
    per-invocation LoRA on the query path) after every ``attn_every``
    of them — Zamba2's shared-attention pattern.

    Parameters live on ``device`` from construction; ``init`` fills them
    from a ``torch.Generator``, ``convert.load_jax_params`` loads a
    ``repro`` tree.  Public layouts are the reference's:

    * cache ``{"m": {"sections": (ssm (n_sec, every, B, H, N, P),
      conv (n_sec, every, B, K-1, C)), "tail": (ssm (n_tail, ...), conv
      (n_tail, ...))}, "a": (k, v)}`` with k, v (n_sec, B, S, KV, D);
    * ``prefill({"tokens": (B, S)})`` and
      ``decode_step(cache, {"token": (B, 1), "pos": (B,)})`` return
      (logits (B, 1, vocab_padded), cache);
    * ``loss({"tokens", "labels"})`` returns (CE, {"ce"}).

    ``decode_step`` writes the new K/V into ``cache["a"]`` IN PLACE and
    returns the same tensors (the reference returns a rewritten copy)."""

    LORA_R = 32

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        _no_tf32()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_sections = cfg.n_layers // cfg.attn_every
        self.n_tail = cfg.n_layers - self.n_sections * cfg.attn_every
        add_params(self, self.param_specs(), self.device)

    def param_specs(self):
        cfg = self.cfg
        d = cfg.d_model
        mamba_block = {
            "ln1": ParamSpec((d,), ("embed",), init="ones"),
            "ln2": ParamSpec((d,), ("embed",), init="ones"),
            "mixer": ssm_lib.mamba2_specs(cfg),
            "ffn": ffn_specs(cfg),
        }
        specs = dict(embed_specs(cfg))
        specs["sections"] = stack_specs(
            stack_specs(mamba_block, cfg.attn_every), self.n_sections)
        if self.n_tail:
            specs["tail"] = stack_specs(mamba_block, self.n_tail)
        specs["shared_attn"] = {
            "ln": ParamSpec((d,), ("embed",), init="ones"),
            "attn": attention_specs(cfg),
            "lora_a": ParamSpec((self.n_sections, d, self.LORA_R),
                                (None, "embed", None), dtype=cfg.dtype),
            "lora_b": ParamSpec(
                (self.n_sections, self.LORA_R, cfg.n_heads, cfg.head_dim),
                (None, None, "heads", None), init="zeros", dtype=cfg.dtype),
        }
        return specs

    def init(self, generator: torch.Generator) -> "HybridModel":
        """Draw every parameter on the CPU from ``generator``, in
        sorted-name order."""
        return draw_params(self, generator)

    # --- blocks -------------------------------------------------------------
    def _mamba_block(self, stacked: ParamTree, idx, x, state, decode):
        """The Mamba2 block of ``stacked`` at ``idx``: (x, its state)."""
        cfg = self.cfg
        pl = stacked.tree(*idx)
        fwd = ssm_lib.mamba2_decode if decode else ssm_lib.mamba2_forward
        h, s2 = fwd(pl["mixer"], rms_norm(x, pl["ln1"]), cfg, state)
        x = x + h
        return x + ffn(pl["ffn"], rms_norm(x, pl["ln2"]), cfg), s2

    def _mamba_stack(self, stacked: ParamTree, idx, n, x, states, decode,
                     remat=False):
        """n Mamba2 blocks of ``stacked`` (layer l at ``(*idx, l)``), each
        with its state (ssm (n, ...), conv (n, ...)).  ``remat`` (the
        loss path) runs each block under ``torch.utils.checkpoint`` and
        returns x and no state (None)."""
        ssm, conv = [], []
        for l in range(n):
            st = (states[0][l], states[1][l])
            if remat:
                x = checkpoint_in_rules(
                    lambda xc, st, l=l: self._mamba_block(
                        stacked, (*idx, l), xc, st, False)[0], x, st)
                continue
            x, (s, c) = self._mamba_block(stacked, (*idx, l), x, st, decode)
            ssm.append(s)
            conv.append(c)
        if remat:
            return x, None
        return x, (torch.stack(ssm), torch.stack(conv))

    def _shared_attn(self, x, sec, positions, cache=None, cache_index=None,
                     seq_axis=None):
        """The shared attention of section ``sec``.  Under a "heads"-
        sharded mesh (ref arch.py:416-425, layers.py:163-164, 235) the
        rank runs its heads, its heads' columns of ``lora_b`` and its
        rows of the shared ``wo``: the LoRA's replicated rank-R input
        enters them and the one stacked product ends in a ``reduce``."""
        cfg = self.cfg
        p = self.shared_attn.tree()         # whole again at every read
        B, S, d = x.shape
        xn = rms_norm(x, p["ln"])
        tp = sharded_axis(p["lora_b"].shape[2], cfg.n_heads, "heads")
        # the per-section LoRA on the query path, through the shared wo
        la = xn @ p["lora_a"][sec]
        lora = (enter(la, tp) if tp else la) \
            @ p["lora_b"][sec].reshape(self.LORA_R, -1)
        out, kv = attention(p["attn"], xn, cfg, positions=positions,
                            cache=cache, cache_index=cache_index,
                            project=False, seq_axis=seq_axis)
        hl = out.shape[2]
        hk = hl * cfg.head_dim
        # both output products in one batched product, the block's last:
        # under remat (the loss path) the checkpoint's recompute stops
        # ahead of it, as the reference's remat drops both (no gradient
        # needs their results)
        y = torch.stack([out.reshape(B, S, hk), lora]) \
            @ p["attn"]["wo"][:hl].reshape(hk, d)
        if tp:
            return x + reduce(y[0] + y[1], tp), kv
        return x + y[0] + y[1], kv

    def _run(self, x, mstates, astates, positions, decode, cache_index=None,
             remat=False, seq_axis=None):
        """Sections of ``attn_every`` Mamba2 blocks, each followed by the
        shared attention, then the tail; returns (x, Mamba2 states, the
        attention's K/V).  ``remat`` (the loss path) checkpoints every
        Mamba2 block and every section's shared attention — without it
        each shared call keeps its (B, H, S, S) float32 scores for the
        backward, as the reference notes — and returns (x, None,
        None)."""
        every = self.cfg.attn_every
        new_m, new_a = [], []
        for sec in range(self.n_sections):
            st = tuple(t[sec] for t in mstates["sections"])
            x, s2 = self._mamba_stack(self.sections, (sec,), every, x, st,
                                      decode, remat)
            if remat:
                x = checkpoint_in_rules(lambda xc, sec=sec: self._shared_attn(
                    xc, sec, positions)[0], x)
                continue
            new_m.append(s2)
            ac = tuple(t[sec] for t in astates) if astates is not None \
                else None
            x, kv = self._shared_attn(x, sec, positions, cache=ac,
                                      cache_index=cache_index,
                                      seq_axis=seq_axis)
            new_a.append(kv)
        if self.n_tail:
            x, s_tail = self._mamba_stack(self.tail, (), self.n_tail, x,
                                          mstates["tail"], decode, remat)
        else:
            s_tail = mstates["tail"]
        if remat:
            return x, None, None
        mst = {"sections": tuple(torch.stack(t) for t in zip(*new_m)),
               "tail": s_tail}
        # decode wrote the ring caches in place: hand back the same tensors
        ast = astates if astates is not None else \
            tuple(torch.stack(t) for t in zip(*new_a))
        return x, mst, ast

    # --- public protocol ----------------------------------------------------
    def loss(self, batch):
        """{"tokens": (B, S), "labels": (B, S)} -> (CE, {"ce"}): from the
        zero state, every Mamba2 block and every section's shared
        attention rematerialised, the chunked CE.  On a CUDA model each
        Mamba2 block launches ``ssd_chunk_intra`` and ``ssd_chunk_state``
        in its forward and again in its recompute (their backward
        launches none)."""
        vp = self.cfg.vocab_padded
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        top = own_params(self)
        x = _embed(top["tok"], tokens, vp)
        positions = torch.arange(x.shape[1], device=self.device)[None, :]
        zero = zero_cache(self, x.shape[0])["m"]
        x, _, _ = self._run(x, zero, None, positions, decode=False,
                            remat=True)
        ce = ce_loss(top["final_norm"], top["unembed"], x, labels,
                     self.cfg.vocab, vp=vp)
        return ce, {"ce": global_ce(ce)}

    @torch.no_grad()
    def prefill(self, batch):
        """{"tokens": (B, S)} -> (last-position logits, cache)."""
        vp = self.cfg.vocab_padded
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        top = own_params(self)
        x = _embed(top["tok"], tokens, vp)
        positions = torch.arange(x.shape[1], device=self.device)[None, :]
        zero = zero_cache(self, x.shape[0])["m"]
        x, mst, ast = self._run(x, zero, None, positions, decode=False)
        return _logits(top["final_norm"], top["unembed"], x[:, -1:], vp), \
            {"m": mst, "a": ast}

    @torch.no_grad()
    def decode_step(self, cache, batch, seq_len=None):
        """One token per sequence: {"token": (B, 1), "pos": (B,)} against
        ``cache`` -> (logits (B, 1, Vp), cache).  ``seq_len`` as the
        Transformer's: it tells a kv_seq-sharded attention ring."""
        vp = self.cfg.vocab_padded
        token = torch.as_tensor(batch["token"], device=self.device).long()
        pos = torch.as_tensor(batch["pos"], device=self.device)
        sa = ring_axis(token.shape[0], cache["a"][0].shape[2], seq_len,
                       seq_len)
        top = own_params(self)
        x = _embed(top["tok"], token, vp)
        x, mst, ast = self._run(x, cache["m"], cache["a"], pos[:, None],
                                decode=True, cache_index=pos, seq_axis=sa)
        return _logits(top["final_norm"], top["unembed"], x, vp), \
            {"m": mst, "a": ast}

    def cache_specs(self, batch: int, seq_len: int):
        """The cache's (shape, dtype) tree (no sharding axes)."""
        cfg = self.cfg
        ssm, conv = ssm_lib.mamba2_state_specs(cfg, batch)

        def stk(*lead):
            return tuple((tuple(lead) + shape, dt) for shape, dt in (ssm, conv))

        kv = ((self.n_sections, batch, max(seq_len, 1), cfg.n_kv_heads,
               cfg.head_dim), DTYPES[cfg.dtype])
        return {"m": {"sections": stk(self.n_sections, cfg.attn_every),
                      "tail": stk(max(self.n_tail, 1))},
                "a": (kv, kv)}

    def cache_axes(self, batch: int, seq_len: int):
        """The logical axes of ``cache_specs``' leaves."""
        per = ssm_lib.mamba2_state_axes()
        kv = ("sections", "batch", kv_seq_axis(batch, seq_len), "kv_heads",
              None)
        return {"m": {"sections": tuple(("sections", "layers") + a
                                        for a in per),
                      "tail": tuple(("layers",) + a for a in per)},
                "a": (kv, kv)}

    def init_cache(self, batch: int, seq_len: int):
        """Zeros of ``cache_specs``; under a process mesh this rank's
        shard (its rows, heads and, where kv_seq shards it, ring
        slots)."""
        return zeros_from_specs(local_spec_tree(
            self.cache_specs(batch, seq_len),
            self.cache_axes(batch, seq_len)), self.device)
