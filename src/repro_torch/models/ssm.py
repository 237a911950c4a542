"""State-space sequence layers in PyTorch: Mamba2 (SSD) and RWKV6 (Finch)
(port of ``repro.models.ssm``).

Mamba2 uses the chunked SSD formulation: within a chunk of ``MAMBA_CHUNK`` tokens the
work is two masked contractions, and only the recurrence across chunks
is sequential.  The two contractions are the kernels of
``repro_torch.kernels.ssd_chunk`` — ``ssd_chunk_intra`` (the intra-chunk
term) and ``ssd_chunk_state`` (each chunk's state summary) — which
launch CUDA on CUDA tensors (through ``autograd.Function``s whose
backward is plain torch, so the layer trains) and run their plain twins
on the CPU.  The inter-chunk recurrence and ``y_inter`` stay plain
PyTorch in float32.

The recurrent state (``ssm`` (B, H, N, P) float32, ``conv`` (B, K-1, C))
is the decode cache.

Under a process mesh (``models.partitioning``) both run on this rank's
heads.  Mamba2's ``w_in`` and ``conv`` are laid out [z | x | B | C | dt]
and cut into contiguous "ff" columns that do not fall on those parts, so
the rank gathers the projection (one all-gather, its gradient summed
back over the axis) and takes its heads' z, x and dt and the whole B and
C (every head reads them); the small ``conv`` weight and, in a decode,
the conv state are gathered likewise.  The gated norm sums its squares
over the axis and ``w_out`` is row-parallel (``reduce``).  RWKV6's
``wr`` / ``wk`` / ``wv`` / ``wg`` are column-parallel on "heads" and
``w_out`` row-parallel; where the heads ("rwkv_heads") do not divide the
axis but the columns do, the rank gathers r, k, v and g (one all-gather)
and runs every head.

RWKV6's WKV recurrence is a per-token scan over a (B, H, 64, 64) float32
state, as in the reference (a ``lax.scan`` in plain jnp there, with no
Pallas kernel): here a plain loop over time in float32.  Its state
(``wkv`` (B, H, 64, 64) float32, ``shift`` (B, 1, d), the last token's
normed input) is the decode cache, and the decode is ``rwkv6_forward``
at L = 1, as in the reference.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_chunk

from .layers import DTYPES, ParamSpec, rms_norm
from .partitioning import (axis_index, axis_size, enter, gather_last, reduce,
                           sharded_axis)

MAMBA_CHUNK = 128


def mamba2_specs(cfg) -> Dict[str, ParamSpec]:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    dt = cfg.dtype
    return {
        # in_proj -> [z(di), x(di), B(N), C(N), dt(H)]
        "w_in": ParamSpec((d, 2 * di + 2 * N + H), ("embed", "ff"), dtype=dt),
        "conv": ParamSpec((cfg.ssm_conv, di + 2 * N), (None, "ff"),
                          init="normal", scale=0.5, dtype=dt),
        "A_log": ParamSpec((H,), ("ssm_heads",), init="value", value=0.0),
        "D": ParamSpec((H,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), init="zeros"),
        "norm": ParamSpec((di,), ("ff",), init="ones"),
        "w_out": ParamSpec((di, d), ("ff", "embed"), dtype=dt),
    }


def _mamba_tp(params, cfg):
    """The mesh axis this rank's Mamba2 heads are sharded on (None off a
    mesh).  Every "ff" weight (``w_in``, ``conv``, the gated norm,
    ``w_out``) must be cut on the same axis: an axis that divides the
    heads divides d_inner and, at every config's widths, 2 N too."""
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    tp = sharded_axis(params["A_log"].shape[0], H, "ssm_heads")
    for name, dim, n in (("w_in", 1, 2 * di + 2 * N + H),
                         ("conv", 1, di + 2 * N), ("norm", 0, di),
                         ("w_out", 0, di)):
        if sharded_axis(params[name].shape[dim], n, "ff") != tp:
            raise ValueError(f"Mamba2 {name} ({params[name].shape[dim]} of "
                             f"{n}) and its heads ({params['A_log'].shape[0]}"
                             f" of {H}) are not cut alike")
    return tp


def _mamba_in(params, u, cfg, conv0):
    """The projection and the causal conv: (z, x, B, C, dt before its
    softplus, the new conv state), x (B, L, Hl, P) on this rank's Hl
    heads (z and dt theirs too), B and C (B, L, N) whole.  Off a mesh
    the model's own slices of one projection; under one (``_mamba_tp``)
    the projection, ``conv`` and the conv state gathered, the conv run
    on every column (a few multiply-adds an element) and this rank's
    columns taken."""
    B, L, _ = u.shape
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    tp = _mamba_tp(params, cfg)
    conv = params["conv"]
    if tp:
        # ref ssm.py:89: constrain(x, (.., "ssm_heads", None)): GSPMD
        # moves the "ff" columns onto the heads; here by gathering
        proj = gather_last(enter(u, tp) @ params["w_in"], tp, partial=True)
        conv = gather_last(conv, tp, partial=True)
        if conv0 is not None:
            conv0 = gather_last(conv0, tp)
    else:
        proj = u @ params["w_in"]
    z, xBC, dtr = (proj[..., :di], proj[..., di:2 * di + 2 * N],
                   proj[..., 2 * di + 2 * N:])
    xBC, conv_state = _causal_conv(xBC, conv, conv0)
    Hl = params["A_log"].shape[0]
    h0 = axis_index(tp) * Hl if tp else 0
    if tp:
        z = z[..., h0 * P:(h0 + Hl) * P]
        dtr = dtr[..., h0:h0 + Hl]
        cl = params["conv"].shape[1]
        conv_state = conv_state[..., axis_index(tp) * cl:
                                (axis_index(tp) + 1) * cl]
    x = xBC[..., h0 * P:(h0 + Hl) * P].reshape(B, L, Hl, P)
    return z, x, xBC[..., di:di + N], xBC[..., di + N:], dtr, conv_state, tp


def _mamba_out(params, y, z, tp):
    """The gated RMS norm over d_inner (its squares summed over ``tp``
    where y holds this rank's heads) and the row-parallel ``w_out``."""
    y = rms_norm(y * F.silu(z), params["norm"], axis=tp)
    out = y @ params["w_out"]
    # ref ssm.py:136: constrain(out, ("batch", "seq", "embed"))
    return reduce(out, tp) if tp else out


def _causal_conv(xBC, weight, state=None):
    """Depthwise causal conv along time, as shifted multiply-adds (not
    ``F.conv1d``: cuDNN would run a float32 convolution in TF32).
    state: (B, K-1, C) history."""
    K = weight.shape[0]
    if state is None:
        pad = xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[-1]))
    else:
        pad = state
    xp = torch.cat([pad.to(xBC.dtype), xBC], dim=1)
    L = xBC.shape[1]
    out = xp[:, 0:L] * weight[0]
    for i in range(1, K):
        out = out + xp[:, i:i + L] * weight[i]
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return F.silu(out), new_state


def mamba2_forward(params, u, cfg, state=None):
    """u: (B, L, d).  Returns (y, (ssm_state, conv_state)).

    ``state``: optional (ssm (B, H, N, P), conv (B, K-1, C)) to continue
    from.  ``L`` must be at most ``MAMBA_CHUNK`` or a multiple of it, as
    the reference's chunk reshape requires; anything else raises."""
    B, L, d = u.shape
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    H = params["A_log"].shape[0]                           # this rank's heads
    if L > MAMBA_CHUNK and L % MAMBA_CHUNK:
        raise ValueError(f"mamba2_forward needs L <= {MAMBA_CHUNK} or a "
                         f"multiple of {MAMBA_CHUNK}, got L={L}")
    Q = min(MAMBA_CHUNK, L)
    nc = L // Q
    if state is not None:
        ssm0, conv0 = state
    else:
        ssm0 = torch.zeros((B, H, N, P), dtype=torch.float32, device=u.device)
        conv0 = None

    z, x, Bm, Cm, dtr, conv_state, tp = _mamba_in(params, u, cfg, conv0)
    dt = F.softplus(dtr.float() + params["dt_bias"])      # (B, L, H)
    A = -torch.exp(params["A_log"].float())               # (H,) negative
    la = dt * A                                           # log-decay <= 0

    # x, B and C go to both SSD kernels as the model's slices of xBC, in
    # its type: the kernels widen each value to float32 as they read it
    # (the reference casts them to float32 first; the values are equal)
    xc = x.reshape(B, nc, Q, H, P)
    Bc = Bm.reshape(B, nc, Q, N)
    Cc = Cm.reshape(B, nc, Q, N)
    dtc = dt.reshape(B, nc, Q, H)
    cum = torch.cumsum(la.reshape(B, nc, Q, H), dim=2)    # (B, nc, Q, H)

    y_intra = ssd_chunk.ssd_chunk_intra(Cc, Bc, xc, cum, dtc,
                                        out_dtype=torch.float32)
    S_c = ssd_chunk.ssd_chunk_state(Bc, xc, cum, dtc)     # (B, nc, H, N, P)
    a_tot = torch.exp(cum[:, :, -1, :])                   # (B, nc, H)

    # inter-chunk recurrence: S_prev[c] is the state entering chunk c
    S = ssm0.float()
    S_prev = torch.empty_like(S_c)
    for c in range(nc):
        S_prev[:, c] = S
        S = a_tot[:, c, :, None, None] * S + S_c[:, c]

    # y_inter[q, h, p] = exp(cum[q, h]) * sum_n C[q, n] S_prev[h, n, p]
    # (only C is widened here: (B, L, N), beside the float32 states)
    CS = torch.matmul(Cc.float(),
                      S_prev.permute(0, 1, 3, 2, 4).reshape(B, nc, N, H * P))
    y_inter = CS.view(B, nc, Q, H, P) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, L, H, P)
    y = y + params["D"].float()[None, None, :, None] * x
    y = y.reshape(B, L, H * P).to(u.dtype)
    return _mamba_out(params, y, z, tp), (S, conv_state)


def mamba2_decode(params, u, cfg, state):
    """Single-token step.  u: (B, 1, d); state from ``mamba2_forward``."""
    B = u.shape[0]
    ssm, conv = state
    z, x, Bm, Cm, dtr, conv, tp = _mamba_in(params, u, cfg, conv)
    H, P = x.shape[2], x.shape[3]                           # this rank's heads
    x = x[:, 0].float()                                     # (B, H, P)
    Bm = Bm[:, 0].float()                                   # (B, N)
    Cm = Cm[:, 0].float()
    dt = F.softplus(dtr[:, 0].float() + params["dt_bias"])  # (B, H)
    A = -torch.exp(params["A_log"].float())
    a = torch.exp(dt * A)
    upd = torch.einsum("bn,bh,bhp->bhnp", Bm, dt, x)
    ssm = a[..., None, None] * ssm + upd
    y = torch.einsum("bn,bhnp->bhp", Cm, ssm) \
        + params["D"].float()[None, :, None] * x
    y = y.reshape(B, 1, H * P).to(u.dtype)
    return _mamba_out(params, y, z, tp), (ssm, conv)


def mamba2_state_specs(cfg, batch: int):
    """((shape, dtype) of ssm, (shape, dtype) of conv) for one layer."""
    B, H, N, P = batch, cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    C = cfg.d_inner + 2 * cfg.ssm_state
    return (((B, H, N, P), torch.float32),
            ((B, cfg.ssm_conv - 1, C), DTYPES[cfg.dtype]))


def mamba2_state_axes():
    """The logical axes of ``mamba2_state_specs``' (ssm, conv)."""
    return (("batch", "ssm_heads", None, None), ("batch", None, "ff"))


# ---------------------------------------------------------------------------
# RWKV6 (Finch): data-dependent decay
# ---------------------------------------------------------------------------

RWKV_HEAD = 64
RWKV_LORA = 64


def rwkv6_specs(cfg) -> Dict[str, ParamSpec]:
    d, dt = cfg.d_model, cfg.dtype
    H = d // RWKV_HEAD
    return {
        "mu": ParamSpec((5, d), (None, "embed"), init="value", value=0.5),
        "w0": ParamSpec((d,), ("embed",), init="value", value=-4.0),
        "w_lora_a": ParamSpec((d, RWKV_LORA), ("embed", None), dtype=dt),
        "w_lora_b": ParamSpec((RWKV_LORA, d), (None, "embed"),
                              init="zeros", dtype=dt),
        "wr": ParamSpec((d, d), ("embed", "heads"), dtype=dt),
        "wk": ParamSpec((d, d), ("embed", "heads"), dtype=dt),
        "wv": ParamSpec((d, d), ("embed", "heads"), dtype=dt),
        "wg": ParamSpec((d, d), ("embed", "heads"), dtype=dt),
        "u": ParamSpec((H, RWKV_HEAD), ("rwkv_heads", None),
                       init="value", value=0.5),
        "ln_out": ParamSpec((d,), ("embed",), init="ones"),
        "w_out": ParamSpec((d, d), ("heads", "embed"), dtype=dt),
    }


def _rwkv_mix(params, x, x_prev):
    """Token-shift mixing for r, k, v, w, g.  x: (B, L, d); x_prev
    (B, 1, d).  ``mu`` is float32: the mix is computed in float32 and
    cast back to x's type.  Returns (5, B, L, d) in the order r, k, v,
    w, g."""
    xx = torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)
    mixed = x[None] + (xx - x)[None] * params["mu"][:, None, None, :]
    return mixed.to(x.dtype)


def _rwkv_wkv_scan(r, k, v, w, u, state):
    """r, k, v: (B, L, H, N); w: (B, L, H, N) decay in (0, 1); u (H, N);
    state (B, H, N, N).  Per token: y = r (S + u kv), S <- w S + kv with
    kv = k v^T.  Returns (y (B, L, H, N), final state)."""
    B, L, H, N = r.shape
    uu = u[None, :, :, None]
    if r.device.type == "meta":
        return _rwkv_wkv_meta(r, k, v, w, uu, state)
    y = r.new_empty((B, L, H, N))
    S = state
    for t in range(L):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]      # (B, H, N, N)
        y[:, t] = torch.matmul(r[:, t, :, None, :], S + uu * kv)[..., 0, :]
        S = w[:, t, :, :, None] * S + kv
    return y, S


def _rwkv_wkv_meta(r, k, v, w, uu, state):
    """``_rwkv_wkv_scan`` on meta tensors (the dry-run), where nothing
    is computed: the loop's L products (B, H, 1, N) x (B, H, N, N) as
    one (B, L, H, 1, N) x (B, L, H, N, N) product, forward and backward
    the same FLOPs, built from the same inputs so every gradient flows
    where the loop's does.  The loop takes seconds per thousand tokens
    on meta; this takes one op."""
    kv = k[..., :, None] * v[..., None, :]                  # (B, L, H, N, N)
    S = w[..., :, None] * state[:, None] + kv
    y = torch.matmul(r[..., None, :], S + uu[:, None] * kv)[..., 0, :]
    return y, S[:, -1]


def rwkv6_forward(params, x, cfg, state=None):
    """x: (B, L, d); state: (wkv (B, H, N, N) float32, shift (B, 1, d)).
    Returns (y, (wkv, shift)); the new shift is ``x[:, -1:]``.  Under
    FSDP with a batch the data axis does not split (one sequence) the
    shift state is cut on its "embed" dimension instead: it is gathered
    here and the new one cut alike."""
    B, L, d = x.shape
    N = RWKV_HEAD
    p = dict(params)
    cols = p["wr"].shape[1]                   # this rank's "heads" columns
    tp = sharded_axis(cols, d, "heads")
    head_ax = sharded_axis(p["u"].shape[0], d // N, "rwkv_heads")
    if head_ax not in (None, tp):
        raise ValueError(f"RWKV6 heads on {head_ax}, columns on {tp}")
    c0 = axis_index(tp) * cols if tp else 0
    if tp:
        # every replicated weight (and the input) reaches this rank's
        # columns only: its gradient is a partial sum over the axis
        x = enter(x, tp)
        for name in ("mu", "w0", "w_lora_a", "w_lora_b", "ln_out") + (
                () if head_ax else ("u",)):
            p[name] = enter(p[name], tp)
    whole = tp is not None and head_ax is None     # gather r, k, v, g
    H = d // N if whole else cols // N             # the heads this rank runs
    if state is None:
        wkv0 = torch.zeros((B, H, N, N), dtype=torch.float32, device=x.device)
        shift0 = x.new_zeros((B, 1, d))
    else:
        wkv0, shift0 = state
    sx = sharded_axis(shift0.shape[-1], d, "embed")
    if sx:
        shift0 = gather_last(shift0, sx)
    xr, xk, xv, xw, xg = _rwkv_mix(p, x, shift0)
    if whole:
        # half a head a rank: the reference's GSPMD gathers the columns
        rkvg = gather_last(torch.stack([xr @ p["wr"], xk @ p["wk"],
                                        xv @ p["wv"], xg @ p["wg"]]), tp,
                           partial=True)
        r, k, v = (t.reshape(B, L, H, N) for t in rkvg[:3])
        g = rkvg[3]
        span = slice(0, d)
    else:
        r = (xr @ p["wr"]).reshape(B, L, H, N)
        k = (xk @ p["wk"]).reshape(B, L, H, N)
        v = (xv @ p["wv"]).reshape(B, L, H, N)
        g = xg @ p["wg"]
        span = slice(c0, c0 + cols)
    g = F.silu(g)
    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(xw))), float32
    lora = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"][:, span]
    wlog = p["w0"][span].float() + lora.float()
    w = torch.exp(-torch.exp(wlog)).reshape(B, L, H, N)
    # ref ssm.py:246: constrain(r, ("batch", "seq", "rwkv_heads", None))
    y, wkv = _rwkv_wkv_scan(r.float(), k.float(), v.float(), w,
                            p["u"].float(), wkv0.float())
    y = y.reshape(B, L, H * N).to(x.dtype)
    ln = p["ln_out"][span]
    y = (rms_norm(y, ln) if whole else rms_norm(y, ln, axis=tp)) * g
    if whole:
        y = y[..., c0:c0 + cols]
    out = y @ p["w_out"]
    shift = x[:, -1:, :]
    if sx:
        n = d // axis_size(sx)
        shift = shift[..., axis_index(sx) * n:(axis_index(sx) + 1) * n]
    # ref ssm.py:254: constrain(out, ("batch", "seq", "embed"))
    return (reduce(out, tp) if tp else out), (wkv, shift)


def rwkv6_state_specs(cfg, batch: int):
    """((shape, dtype) of wkv, (shape, dtype) of shift) for one layer."""
    d = cfg.d_model
    H, N = d // RWKV_HEAD, RWKV_HEAD
    return (((batch, H, N, N), torch.float32),
            ((batch, 1, d), DTYPES[cfg.dtype]))


def rwkv6_state_axes():
    """The logical axes of ``rwkv6_state_specs``' (wkv, shift)."""
    return (("batch", "rwkv_heads", None, None), ("batch", None, "embed"))
