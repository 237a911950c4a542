"""Architecture assembly, in PyTorch (port of ``repro.models.arch``).

The embedding / unembedding, the chunked training loss and the layer
stacking shared by the families, the decoder-only Transformer (dense,
MoE and VLM: ``TransformerModel``), the attention-free SSM stacks
(RWKV6 and Mamba2: ``SSMModel``) and the Zamba2 hybrid
(``HybridModel``).  The encoder-decoder is ``models/encdec.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device

from . import ssm as ssm_lib
from .config import InputShape, ModelConfig
from .layers import (DTYPES, ParamSpec, attention, attention_specs,
                     cross_entropy, ffn, ffn_specs, rms_norm)
from .moe import moe_ffn, moe_specs, shared_expert_ffn


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


def _embed(tok, tokens):
    return tok[tokens]


def _logits(final_norm, unembed, x):
    return rms_norm(x, final_norm) @ unembed


CE_CHUNK = 512


def ce_loss(final_norm, unembed, x, labels, vocab: int,
            chunk: int = CE_CHUNK):
    """Sequence-chunked cross-entropy: the (B, S, vocab_padded) logits
    are the largest training temporary (1.64 GB f32 per 512-token chunk
    at B 8 for hstu-gr), so each chunk's logits are computed under a
    ``torch.utils.checkpoint`` and only one (B, chunk, Vp) slice is
    alive at a time, in the backward too.  The same value as the
    unchunked mean (sum / (B S)); S <= chunk or S % chunk != 0 computes
    it unchunked."""
    B, S, _ = x.shape
    if S <= chunk or S % chunk:
        return cross_entropy(_logits(final_norm, unembed, x), labels,
                             vocab).mean()

    def one(xx, ll):
        return cross_entropy(_logits(final_norm, unembed, xx), ll,
                             vocab).sum()

    tot = sum(checkpoint(one, x[:, i:i + chunk], labels[:, i:i + chunk],
                         use_reentrant=False) for i in range(0, S, chunk))
    return tot / (B * S)


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
    """Lay ``specs`` out on ``module``: a leaf becomes a parameter, a
    dict a ``ParamTree`` submodule, each named by its key — so
    ``state_dict`` names are the reference tree's paths
    (``sections.mixer.w_in``)."""
    for k, s in specs.items():
        if isinstance(s, ParamSpec):
            module.register_parameter(k, nn.Parameter(
                torch.empty(s.shape, dtype=DTYPES[s.dtype], device=device),
                requires_grad=False))
        else:
            module.add_module(k, ParamTree(s, device))


class ParamTree(nn.Module):
    """A subtree of parameters (see ``add_params``)."""

    def __init__(self, specs, device):
        super().__init__()
        add_params(self, specs, device)

    def tree(self, *idx):
        """The subtree as nested dicts of tensors, each indexed by
        ``idx`` (a view: one layer of a stack)."""
        out = {k: p[idx] if idx else p for k, p in self._parameters.items()}
        out.update({k: m.tree(*idx) for k, m in self._modules.items()})
        return out


def draw_params(model: nn.Module, generator: torch.Generator):
    """Fill every parameter of ``model`` (laid out by ``add_params`` from
    ``model.param_specs()``) on the CPU from ``generator`` (so the
    weights do not depend on the device), in sorted-name order."""
    params = dict(model.named_parameters())
    specs = flat_specs(model.param_specs())
    with torch.no_grad():
        for name in sorted(specs):
            params[name].copy_(specs[name].initialise(generator))
    return model


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


def _no_tf32():
    """float32 products stay float32 on the card (no TF32 rounding)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ===========================================================================
# Dense / MoE / VLM decoder-only Transformer
# ===========================================================================


class TransformerModel(nn.Module):
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
      (logits (B, 1, vocab_padded), cache).

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
               window=0):
        cfg = self.cfg
        h, kvc = attention(p["attn"], rms_norm(x, p["ln1"]), cfg,
                           positions=positions, cache=cache,
                           cache_index=cache_index, window=window)
        x = x + h
        xn = rms_norm(x, p["ln2"])
        if self.is_moe:
            # the routing feeds ``moe_aux`` on the training path
            # (ROADMAP Queue 1, item 11)
            y, _ = moe_ffn(p["moe"], xn, cfg)
            if cfg.n_shared_experts:
                y = y + shared_expert_ffn(p["moe"], xn, cfg)
        else:
            y = ffn(p["ffn"], xn, cfg)
        return x + y, kvc

    def _run(self, x, positions, cache=None, cache_index=None, window=0):
        """The stacked layers in turn, each a view of the stack.  With a
        ``cache`` (decode) its layer slices are updated in place and the
        same tuple returned; without one (prefill) every layer's K/V is
        copied into one stacked (n_layers, B, S, KV, D) pair."""
        L = self.cfg.n_layers
        kv = cache
        for l in range(L):
            cl = None if cache is None else tuple(t[l] for t in cache)
            x, kvc = self._block(self.layers.tree(l), x, positions, cache=cl,
                                 cache_index=cache_index, window=window)
            if cache is None:
                if kv is None:
                    kv = tuple(torch.empty((L,) + tuple(t.shape),
                                           dtype=t.dtype, device=t.device)
                               for t in kvc)
                for dst, src in zip(kv, kvc):
                    dst[l] = src
        return x, kv

    # --- public protocol ----------------------------------------------------
    def loss(self, batch):
        raise NotImplementedError(
            f"{self.cfg.name}: TransformerModel.loss is not ported to "
            f"repro_torch yet (ROADMAP Queue 1, item 11)")

    @torch.no_grad()
    def prefill(self, batch):
        """{"tokens": (B, S)} (a VLM also takes "frontend" (B, F, d),
        cast to the model's type) -> (last-position logits, cache); the
        frontend's F positions come first, positions run over F + S."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        x = _embed(self.tok, tokens)
        if cfg.family == "vlm" and "frontend" in batch:
            fe = torch.as_tensor(batch["frontend"], device=self.device)
            fe = torch.einsum("bfd,de->bfe", fe.to(self.projector.dtype),
                              self.projector)
            x = torch.cat([fe.to(x.dtype), x], dim=1)
        positions = torch.arange(x.shape[1], device=self.device)[None, :]
        x, kv = self._run(x, positions, window=cfg.sliding_window)
        return _logits(self.final_norm, self.unembed, x[:, -1:]), kv

    @torch.no_grad()
    def decode_step(self, cache, batch):
        """One token per sequence: {"token": (B, 1), "pos": (B,)} against
        ``cache`` -> (logits (B, 1, Vp), the same cache, updated)."""
        token = torch.as_tensor(batch["token"], device=self.device).long()
        pos = torch.as_tensor(batch["pos"], device=self.device)
        x = _embed(self.tok, token)
        x, cache = self._run(x, pos[:, None], cache=tuple(cache),
                             cache_index=pos)
        return _logits(self.final_norm, self.unembed, x), cache

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

    def init_cache(self, batch: int, seq_len: int):
        """Zeros of ``cache_specs`` (the reference's ``init_cache`` takes
        the unquantized layout only; here the int8 one too, with zero
        scales)."""
        return zeros_from_specs(self.cache_specs(batch, seq_len),
                                self.device)

    def batch_specs(self, shape: InputShape):
        """The entry point's batch as {name: (shape, dtype)}."""
        specs = base_batch_specs(shape)
        if self.cfg.family == "vlm" and shape.kind != "decode":
            specs["frontend"] = ((shape.global_batch,
                                  self.cfg.n_frontend_tokens,
                                  self.cfg.d_model), DTYPES[self.cfg.dtype])
        return specs


# ===========================================================================
# SSM stacks (Mamba2 / RWKV6)
# ===========================================================================


class SSMModel(nn.Module):
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
      (logits (B, 1, vocab_padded), new state).

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

    def _run(self, x, state, decode=False):
        """The stacked layers in turn, layer l with (state[0][l],
        state[1][l]); returns x and the new state, stacked."""
        cfg = self.cfg
        new = ([], [])
        for l in range(cfg.n_layers):
            pl = self.layers.tree(l)
            h, s2 = self._mix(pl["mixer"], rms_norm(x, pl["ln1"]),
                              (state[0][l], state[1][l]), decode)
            x = x + h
            x = x + ffn(pl["ffn"], rms_norm(x, pl["ln2"]), cfg)
            for acc, t in zip(new, s2):
                acc.append(t)
        return x, tuple(torch.stack(t) for t in new)

    # --- public protocol ----------------------------------------------------
    def loss(self, batch):
        raise NotImplementedError(
            f"{self.cfg.name}: SSMModel.loss is not ported to repro_torch "
            f"yet (ROADMAP Queue 1, item 11)")

    @torch.no_grad()
    def prefill(self, batch):
        """{"tokens": (B, S)} -> (last-position logits, state), from a
        zero state."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        x = _embed(self.tok, tokens)
        x, state = self._run(x, self.init_cache(x.shape[0], 0))
        return _logits(self.final_norm, self.unembed, x[:, -1:]), state

    @torch.no_grad()
    def decode_step(self, cache, batch):
        """One token per sequence: {"token": (B, 1), "pos": (B,)} (``pos``
        unused: the state carries the position) against ``cache`` ->
        (logits (B, 1, Vp), new state)."""
        token = torch.as_tensor(batch["token"], device=self.device).long()
        x = _embed(self.tok, token)
        x, state = self._run(x, cache, decode=True)
        return _logits(self.final_norm, self.unembed, x), state

    def cache_specs(self, batch: int, seq_len: int):
        """The state's (shape, dtype) tuple (no sharding axes); it does
        not depend on ``seq_len``."""
        cfg = self.cfg
        per = (ssm_lib.mamba2_state_specs(cfg, batch) if self.is_mamba
               else ssm_lib.rwkv6_state_specs(cfg, batch))
        return tuple(((cfg.n_layers,) + shape, dt) for shape, dt in per)

    def init_cache(self, batch: int, seq_len: int):
        return zeros_from_specs(self.cache_specs(batch, seq_len),
                                self.device)

    def batch_specs(self, shape: InputShape):
        """The entry point's batch as {name: (shape, dtype)}."""
        return base_batch_specs(shape)


# ===========================================================================
# Hybrid (Zamba2): mamba2 backbone + shared attention blocks
# ===========================================================================


class HybridModel(nn.Module):
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
      (logits (B, 1, vocab_padded), cache).

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
    def _mamba_stack(self, stacked: ParamTree, idx, n, x, states, decode):
        """n Mamba2 blocks of ``stacked`` (layer l at ``(*idx, l)``), each
        with its state (ssm (n, ...), conv (n, ...))."""
        cfg = self.cfg
        fwd = ssm_lib.mamba2_decode if decode else ssm_lib.mamba2_forward
        ssm, conv = [], []
        for l in range(n):
            pl = stacked.tree(*idx, l)
            h, (s, c) = fwd(pl["mixer"], rms_norm(x, pl["ln1"]), cfg,
                            (states[0][l], states[1][l]))
            x = x + h
            x = x + ffn(pl["ffn"], rms_norm(x, pl["ln2"]), cfg)
            ssm.append(s)
            conv.append(c)
        return x, (torch.stack(ssm), torch.stack(conv))

    def _shared_attn(self, x, sec, positions, cache=None, cache_index=None):
        cfg = self.cfg
        p = self.shared_attn
        B, S, d = x.shape
        xn = rms_norm(x, p.ln)
        # the per-section LoRA on the query path, through the shared wo
        lora = (xn @ p.lora_a[sec]) @ p.lora_b[sec].reshape(self.LORA_R, -1)
        h, kv = attention(p.attn.tree(), xn, cfg, positions=positions,
                          cache=cache, cache_index=cache_index)
        wo = p.attn.wo.reshape(cfg.n_heads * cfg.head_dim, d)
        return x + h + lora @ wo, kv

    def _run(self, x, mstates, astates, positions, decode, cache_index=None):
        every = self.cfg.attn_every
        new_m, new_a = [], []
        for sec in range(self.n_sections):
            st = tuple(t[sec] for t in mstates["sections"])
            x, s2 = self._mamba_stack(self.sections, (sec,), every, x, st,
                                      decode)
            new_m.append(s2)
            ac = tuple(t[sec] for t in astates) if astates is not None \
                else None
            x, kv = self._shared_attn(x, sec, positions, cache=ac,
                                      cache_index=cache_index)
            new_a.append(kv)
        if self.n_tail:
            x, s_tail = self._mamba_stack(self.tail, (), self.n_tail, x,
                                          mstates["tail"], decode)
        else:
            s_tail = mstates["tail"]
        mst = {"sections": tuple(torch.stack(t) for t in zip(*new_m)),
               "tail": s_tail}
        # decode wrote the ring caches in place: hand back the same tensors
        ast = astates if astates is not None else \
            tuple(torch.stack(t) for t in zip(*new_a))
        return x, mst, ast

    # --- public protocol ----------------------------------------------------
    @torch.no_grad()
    def prefill(self, batch):
        """{"tokens": (B, S)} -> (last-position logits, cache)."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        x = _embed(self.tok, tokens)
        positions = torch.arange(x.shape[1], device=self.device)[None, :]
        zero = self.init_cache(x.shape[0], 0)["m"]
        x, mst, ast = self._run(x, zero, None, positions, decode=False)
        return _logits(self.final_norm, self.unembed, x[:, -1:]), \
            {"m": mst, "a": ast}

    @torch.no_grad()
    def decode_step(self, cache, batch):
        """One token per sequence: {"token": (B, 1), "pos": (B,)} against
        ``cache`` -> (logits (B, 1, Vp), cache)."""
        token = torch.as_tensor(batch["token"], device=self.device).long()
        pos = torch.as_tensor(batch["pos"], device=self.device)
        x = _embed(self.tok, token)
        x, mst, ast = self._run(x, cache["m"], cache["a"], pos[:, None],
                                decode=True, cache_index=pos)
        return _logits(self.final_norm, self.unembed, x), {"m": mst, "a": ast}

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

    def init_cache(self, batch: int, seq_len: int):
        return zeros_from_specs(self.cache_specs(batch, seq_len),
                                self.device)
