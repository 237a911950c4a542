"""Core layers, in PyTorch (port of ``repro.models.layers``).

What every family needs: ``ParamSpec`` (the fan-in normal init rule),
``rms_norm``, interleaved-pair RoPE, GQA softmax attention (prefill,
q-chunked prefill, ring-cache decode with padded heads and the int8 KV
cache, and cross-attention over given K/V), the GLU or plain FFN and
the vocab-padded cross-entropy.
Tensors keep the reference's layouts: (..., S, H, D) for heads.  Layers
are functions of a parameter dict, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .partitioning import (axis_index, axis_size, enter, reduce,
                           sharded_axis)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | value
    scale: float = 1.0          # stddev multiplier for "normal"
    value: float = 0.0          # for init == "value"
    dtype: str = "float32"

    def initialise(self, generator: torch.Generator) -> torch.Tensor:
        """Draw on the CPU from ``generator`` (device-independent
        numbers), with the reference's rule: ``scale / sqrt(fan_in)``
        with fan_in the second-to-last dim.  ``jax.random`` gives other
        numbers from the same seed, so cross-framework tests load one
        set of weights into both (``models/convert.py``)."""
        dt = DTYPES[self.dtype]
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt)
        if self.init == "value":
            return torch.full(self.shape, self.value, dtype=dt)
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32)
        return (x * self.std).to(dt)

    @property
    def std(self) -> float:
        """The "normal" draw's stddev: ``scale / sqrt(fan_in)``."""
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        return self.scale / math.sqrt(max(fan_in, 1))


def abstract_tree(specs):
    """A ParamSpec tree as (shape, dtype) leaves: the parameters'
    stand-ins for the dry-run, nothing allocated."""
    if isinstance(specs, ParamSpec):
        return (tuple(specs.shape), DTYPES[specs.dtype])
    return {k: abstract_tree(s) for k, s in specs.items()}


def axes_tree(specs):
    """A ParamSpec tree as its logical axes."""
    if isinstance(specs, ParamSpec):
        return tuple(specs.axes)
    return {k: axes_tree(s) for k, s in specs.items()}


def _wide(dtype) -> torch.dtype:
    """The type a reduction computes in: float32 for 16- and 32-bit
    floats, float64 for float64 (the CPU's float64 reference)."""
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x, weight, eps: float = 1e-6, axis=None):
    """RMS norm computed in float32 (float64 for float64 input) whatever
    the input type.  ``axis``: the last dimension is sharded over that
    mesh axis (HSTU's ``ln_attn`` over its heads): the sum of squares is
    summed over it (``reduce``, then ``enter``: every rank's slice
    depends on the whole sum) before the mean."""
    dt = x.dtype
    x = x.to(_wide(dt))
    if axis is None:
        var = x.square().mean(dim=-1, keepdim=True)
    else:
        var = enter(reduce(x.square().sum(dim=-1, keepdim=True), axis),
                    axis) / (x.shape[-1] * axis_size(axis))
    out = x * torch.rsqrt(var + eps) * weight.to(x.dtype)
    return out.to(dt)


def rope_frequencies(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions, head_dim: int, theta: float):
    """cos and sin of the rotation angles, (..., S, D/2) for positions
    (..., S): computed once per forward and shared by every layer."""
    freqs = rope_frequencies(head_dim, theta, device=positions.device)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def rotate_pairs(x, cos, sin):
    """Rotate interleaved pairs (x[2i], x[2i+1]) by angles whose cos/sin
    broadcast against x[..., ::2] — the reference's convention, not
    rotate-half."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    cos, sin = rope_tables(positions, x.shape[-1], theta)
    return rotate_pairs(x, cos[..., None, :], sin[..., None, :])


def _act(name: str):
    return {"silu": F.silu, "relu": F.relu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


# ---------------------------------------------------------------------------
# Attention (GQA, optional qk-norm, sliding window, ring KV cache)
# ---------------------------------------------------------------------------


# int8 KV cache: symmetric, a dynamic scale per token and kv head


def quantize_kv(x):
    """x (..., D) -> (int8 values, float32 scales (..., 1)): scale
    ``max|x| / 127 + 1e-8``, values rounded half to even (as
    ``jnp.round``) and clipped to +-127."""
    xf = x.float()
    s = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / s), -127, 127)
    return q.to(torch.int8), s


def dequantize_kv(q, s, dtype):
    return (q.float() * s).to(dtype)


def attention_specs(cfg, d_in=None) -> Dict[str, ParamSpec]:
    """wq / wo carry ``max(n_heads, head_pad)`` heads: the padded ones
    are zeroed before ``wo`` (Megatron-style head padding)."""
    d = d_in or cfg.d_model
    h, kv, hd, dt = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.dtype
    h = max(h, cfg.head_pad)
    specs = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", None), dtype=dt),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", None), dtype=dt),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", None), dtype=dt),
        "wo": ParamSpec((h, hd, d), ("heads", None, "embed"), dtype=dt),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), (None,), init="ones")
        specs["k_norm"] = ParamSpec((hd,), (None,), init="ones")
    return specs


def _sdpa(q, k, v, mask, scale):
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D).  GQA: q head h reads kv
    head ``h * KV // H``.  Logits and softmax in float32, the weights
    cast to v's type before the PV product, as in the reference.  Runs
    under the profiler range ``sdpa``, which a profile of a train step
    follows into the backward (``chip_smoke.py``'s ``lmtrain``)."""
    with torch.profiler.record_function("sdpa"):
        H, KV = q.shape[2], k.shape[2]
        if H != KV:
            kmap = torch.arange(H, device=k.device) * KV // H
            k, v = k[:, :, kmap], v[:, :, kmap]
        logits = torch.einsum("bqhd,bshd->bhqs", q, k).float() * scale
        if mask is not None:
            logits = torch.where(mask, logits, -1e30)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        return torch.einsum("bhqs,bshd->bqhd", w, v)


def _causal_mask(q0: int, nq: int, nk: int, device, prefix_len=0, window=0):
    qi = q0 + torch.arange(nq, device=device)[:, None]
    ki = torch.arange(nk, device=device)[None, :]
    m = ki <= qi
    if prefix_len:
        m = m | (ki < prefix_len)
    if window:
        m = m & (ki > qi - window)
    return m


def _sdpa_q_chunked(q, k, v, scale, chunk, *, prefix_len=0, window=0):
    """Causal attention with the query axis in chunks of ``chunk``: caps
    the score tile at (B, H, chunk, keys).  Chunk i attends to the keys
    up to its last query only (or the whole prefix, if longer): the keys
    past them are masked, and a masked logit of -1e30 has a softmax
    weight of exactly 0, so dropping them changes no value."""
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    for q0 in range(0, S, chunk):
        nk = min(S, max(q0 + chunk, prefix_len))
        m = _causal_mask(q0, chunk, nk, q.device, prefix_len, window)
        out[:, q0:q0 + chunk] = _sdpa(q[:, q0:q0 + chunk], k[:, :nk],
                                      v[:, :nk], m, scale)
    return out


def attention(params, x, cfg, *, positions, cache=None, cache_index=None,
              kv_override=None, window: int = 0, causal: bool = True,
              prefix_len: int = 0, project: bool = True):
    """Attention, as ``repro.models.layers.attention``.

    * prefill (``cache`` None): causal (or bidirectional) self-attention
      over ``x`` (B, S, d); q-chunked when ``S >= 4 * attn_q_chunk``.
      Returns (out, (k, v)) with k, v (B, S, KV, D), unquantized under
      ``kv_quant`` too, as in the reference.
    * decode (``cache`` = (k, v), each (B, Sc, KV, D), or under
      ``kv_quant`` (k int8, v int8, k scales, v scales (B, Sc, KV, 1)),
      ``cache_index`` (B,) int): the new K/V go to ring slot
      ``cache_index % Sc`` and one query attends over the whole ring
      through the ``decode_attn`` kernel (no length mask: every slot is
      live).  An int8 ring is dequantized whole to the model's type
      first, as the reference does before its ``_sdpa``.

    * cross-attention (``kv_override`` = (k, v), each (B, F, KV, D)):
      k and v are taken as given (no ``k_norm``; ``q_norm`` still
      applies), neither q nor k is rotated, nothing is cached and
      nothing masked.  S queries go through the plain ``_sdpa``; one
      query (the enc-dec decode) through the ``decode_attn`` kernel,
      which over F live slots computes the reference's ``_sdpa`` with
      ``mask=None``.  Returns (out, (k, v)) as given.

    With ``head_pad`` > ``n_heads`` only the real heads' slices of
    ``wq`` and ``wo`` are used: the reference zeroes the padded heads'
    outputs before ``wo``, so they add nothing, and computing the real
    heads alone keeps head h on kv head ``h * KV // n_heads`` in every
    path.

    ``project=False`` returns the heads' output (B, S, n_heads, D)
    before ``wo`` in place of the projected (B, S, d): a caller that
    projects it together with another product (the hybrid's shared
    attention)."""
    B, S, d = x.shape
    wq, wo = params["wq"], params["wo"]
    tp, h0, n_real, kv_lo, kv_hi = _local_heads(cfg, wq.shape[1],
                                                params["wk"].shape[1])
    if wq.shape[1] > n_real:
        wq, wo = wq[:, :n_real], wo[:n_real]
    wk, wv = params["wk"], params["wv"]
    q_norm, k_norm = params.get("q_norm"), params.get("k_norm")
    if tp:
        # ref layers.py:139-146, 163-164: q on this rank's heads; a
        # replicated weight or activation entering them sums its partial
        # gradients over "model"
        x = enter(x, tp)
        if cfg.qk_norm:
            q_norm, k_norm = enter(q_norm, tp), enter(k_norm, tp)
        if kv_hi - kv_lo < wk.shape[1]:          # kv heads replicated
            wk, wv = enter(wk, tp), enter(wv, tp)
    q = torch.einsum("bsd,dhk->bshk", x, wq)
    if kv_override is None:
        k = torch.einsum("bsd,dhk->bshk", x, wk)
        v = torch.einsum("bsd,dhk->bshk", x, wv)
    else:
        k, v = kv_override
    if cfg.qk_norm:
        q = rms_norm(q, q_norm)
        if kv_override is None:
            k = rms_norm(k, k_norm)
    if cfg.rope_theta and kv_override is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    mine = slice(kv_lo, kv_hi)                   # the kv heads q reads

    if kv_override is not None:
        out = (ops.cache_decode_attention(q, k, v) if S == 1
               else _sdpa(q, k, v, None, scale))
        new_cache = (k, v)
    elif cache is not None:
        if cfg.kv_quant and len(cache) != 4:
            raise ValueError(
                f"kv_quant decode needs the int8 ring (k int8, v int8, "
                f"k scales, v scales), each (B, S, KV, D) / (B, S, KV, 1); "
                f"got a {len(cache)}-tuple (a prefill returns (k, v) "
                f"unquantized: quantize it with quantize_kv first)")
        ck, cv = cache[:2]
        if cache_index is not None:
            # The reference rewrites the whole cache with a one-hot
            # ``where``; here the new entry is written IN PLACE into the
            # caller's cache (one row per sequence) — a deliberate
            # difference that saves a full copy of the cache per step.
            rows = torch.arange(B, device=x.device)
            slot = (cache_index.to(x.device).long() % ck.shape[1])
            if cfg.kv_quant:
                for dst, scl, new in ((ck, cache[2], k), (cv, cache[3], v)):
                    qv, qs = quantize_kv(new[:, 0])
                    dst[rows, slot] = qv
                    scl[rows, slot] = qs
            else:
                ck[rows, slot] = k[:, 0].to(ck.dtype)
                cv[rows, slot] = v[:, 0].to(cv.dtype)
        if cfg.kv_quant:
            ck = dequantize_kv(ck, cache[2], k.dtype)
            cv = dequantize_kv(cv, cache[3], v.dtype)
        out = (ops.cache_decode_attention(q, ck[:, :, mine], cv[:, :, mine])
               if n_real else q)
        new_cache = cache
    else:
        qc = cfg.attn_q_chunk
        ka, va = k[:, :, mine], v[:, :, mine]
        if not n_real:
            out = q
        elif qc and S >= 4 * qc and S % qc == 0 and causal:
            out = _sdpa_q_chunked(q, ka, va, scale, qc,
                                  prefix_len=prefix_len, window=window)
        else:
            mask = (_causal_mask(0, S, S, x.device, prefix_len, window)
                    if causal else None)
            out = _sdpa(q, ka, va, mask, scale)
        new_cache = (k, v)
    if not project:
        return out, new_cache
    y = torch.einsum("bshk,hkd->bsd", out, wo)
    # ref layers.py:235: constrain(y, ("batch", "seq", "embed"))
    return (reduce(y, tp) if tp else y), new_cache


def _local_heads(cfg, hl: int, kvl: int):
    """This rank's attention heads from its local ``wq`` / ``wk`` head
    counts: (the "model" axis the heads are sharded on or None, the
    first local head's global index, how many local heads are real (not
    ``head_pad``'s), and the kv heads [kv_lo, kv_hi) of the local
    ``wk`` they read).  q head h reads kv head ``h * KV // n_heads``;
    with kv heads replicated (a count the axis does not divide) a rank
    keeps only those its own q heads read, so that ``decode_attn`` is
    given this rank's (G, KV) and never the first heads of the ring."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    hp = max(h, cfg.head_pad)
    tp = sharded_axis(hl, hp, "heads")
    kv_ax = sharded_axis(kvl, kv, "kv_heads")
    h0 = axis_index(tp) * hl if tp else 0
    n_real = max(0, min(hl, h - h0))
    if not tp:
        if kv_ax:
            raise ValueError(f"kv heads sharded ({kvl} of {kv}) under "
                             f"replicated q heads ({hl})")
        return None, 0, n_real, 0, kvl
    if not n_real:
        return tp, h0, 0, 0, 0
    kv0 = axis_index(kv_ax) * kvl if kv_ax else 0
    kv_lo = h0 * kv // h - kv0
    kv_hi = (h0 + n_real - 1) * kv // h + 1 - kv0
    nk = kv_hi - kv_lo
    if not (0 <= kv_lo < kv_hi <= kvl) or any(
            (h0 + i) * kv // h - kv0 - kv_lo != i * nk // n_real
            for i in range(n_real)):
        raise ValueError(f"heads [{h0}, {h0 + n_real}) of {h} do not read "
                         f"whole groups of the local kv heads "
                         f"[{kv0}, {kv0 + kvl}) of {kv}")
    return tp, h0, n_real, kv_lo, kv_hi


# ---------------------------------------------------------------------------
# Feed-forward (GLU or plain)
# ---------------------------------------------------------------------------


def ffn_specs(cfg, d_ff=None) -> Dict[str, ParamSpec]:
    d, f, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.dtype
    specs = {"wi": ParamSpec((d, f), ("embed", "ff"), dtype=dt)}
    if cfg.glu:
        specs["wg"] = ParamSpec((d, f), ("embed", "ff"), dtype=dt)
    specs["wo"] = ParamSpec((f, d), ("ff", "embed"), dtype=dt)
    return specs


def ffn(params, x, cfg):
    """The GLU (or plain) FFN of width ``cfg.d_ff``.
    Under an "ff"-sharded ``wi`` (ref layers.py:300-324): the input
    enters the column-parallel ``wi`` / ``wg``, the row-parallel ``wo``
    leaves a partial sum, reduced over the axis."""
    act = _act(cfg.act)
    tp = sharded_axis(params["wi"].shape[1], cfg.d_ff, "ff")
    if tp:
        x = enter(x, tp)
    h = x @ params["wi"]
    h = act(x @ params["wg"]) * h if cfg.glu else act(h)
    y = h @ params["wo"]
    # ref layers.py:322, 324: constrain(h, (.., "ff")), then (.., "embed")
    return reduce(y, tp) if tp else y


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def cross_entropy(logits, labels, vocab: int):
    """logits: (..., Vp) possibly vocab-padded; labels int (...).  Per
    position ``logsumexp - gold`` in float32 (float64 for float64
    logits), the padded ids masked to -1e30 first."""
    vp = logits.shape[-1]
    logits = logits.to(_wide(logits.dtype))
    if vp > vocab:
        vid = torch.arange(vp, device=logits.device)
        logits = torch.where(vid < vocab, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return logz - gold
