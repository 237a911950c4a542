"""State-space sequence layers in PyTorch: Mamba2 (SSD) and RWKV6 (Finch)
(port of ``repro.models.ssm``).

Mamba2 uses the chunked SSD formulation: within a chunk of ``MAMBA_CHUNK`` tokens the
work is two masked contractions, and only the recurrence across chunks
is sequential.  The two contractions are the kernels of
``repro_torch.kernels.ssd_chunk`` — ``ssd_chunk_intra`` (the intra-chunk
term) and ``ssd_chunk_state`` (each chunk's state summary) — which
launch CUDA on CUDA tensors and run their plain twins on the CPU.  The
inter-chunk recurrence and ``y_inter`` stay plain PyTorch in float32.

The recurrent state (``ssm`` (B, H, N, P) float32, ``conv`` (B, K-1, C))
is the decode cache.

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


def _mamba_split(params, u, cfg):
    di, N = cfg.d_inner, cfg.ssm_state
    proj = u @ params["w_in"]
    return proj[..., :di], proj[..., di:2 * di + 2 * N], \
        proj[..., 2 * di + 2 * N:]


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
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
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

    z, xBC, dtr = _mamba_split(params, u, cfg)
    xBC, conv_state = _causal_conv(xBC, params["conv"], conv0)
    x = xBC[..., :di].reshape(B, L, H, P)
    dt = F.softplus(dtr.float() + params["dt_bias"])      # (B, L, H)
    A = -torch.exp(params["A_log"].float())               # (H,) negative
    la = dt * A                                           # log-decay <= 0

    xc = x.reshape(B, nc, Q, H, P).float()
    Bc = xBC[..., di:di + N].reshape(B, nc, Q, N).float()
    Cc = xBC[..., di + N:].reshape(B, nc, Q, N).float()
    dtc = dt.reshape(B, nc, Q, H)
    cum = torch.cumsum(la.reshape(B, nc, Q, H), dim=2)    # (B, nc, Q, H)

    y_intra = ssd_chunk.ssd_chunk_intra(Cc, Bc, xc, cum, dtc)
    S_c = ssd_chunk.ssd_chunk_state(Bc, xc, cum, dtc)     # (B, nc, H, N, P)
    a_tot = torch.exp(cum[:, :, -1, :])                   # (B, nc, H)

    # inter-chunk recurrence: S_prev[c] is the state entering chunk c
    S = ssm0.float()
    S_prev = torch.empty_like(S_c)
    for c in range(nc):
        S_prev[:, c] = S
        S = a_tot[:, c, :, None, None] * S + S_c[:, c]

    # y_inter[q, h, p] = exp(cum[q, h]) * sum_n C[q, n] S_prev[h, n, p]
    CS = torch.matmul(Cc, S_prev.permute(0, 1, 3, 2, 4).reshape(B, nc, N, H * P))
    y_inter = CS.view(B, nc, Q, H, P) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, L, H, P)
    y = y + params["D"].float()[None, None, :, None] * x
    y = y.reshape(B, L, di).to(u.dtype)
    y = rms_norm(y * F.silu(z), params["norm"])
    return y @ params["w_out"], (S, conv_state)


def mamba2_decode(params, u, cfg, state):
    """Single-token step.  u: (B, 1, d); state from ``mamba2_forward``."""
    B = u.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    ssm, conv = state
    z, xBC, dtr = _mamba_split(params, u, cfg)
    xBC, conv = _causal_conv(xBC, params["conv"], conv)
    x = xBC[:, 0, :di].reshape(B, H, P).float()
    Bm = xBC[:, 0, di:di + N].float()                      # (B, N)
    Cm = xBC[:, 0, di + N:].float()
    dt = F.softplus(dtr[:, 0].float() + params["dt_bias"])  # (B, H)
    A = -torch.exp(params["A_log"].float())
    a = torch.exp(dt * A)
    upd = torch.einsum("bn,bh,bhp->bhnp", Bm, dt, x)
    ssm = a[..., None, None] * ssm + upd
    y = torch.einsum("bn,bhnp->bhp", Cm, ssm) \
        + params["D"].float()[None, :, None] * x
    y = y.reshape(B, 1, di).to(u.dtype)
    y = rms_norm(y * F.silu(z), params["norm"])
    return y @ params["w_out"], (ssm, conv)


def mamba2_state_specs(cfg, batch: int):
    """((shape, dtype) of ssm, (shape, dtype) of conv) for one layer."""
    B, H, N, P = batch, cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    C = cfg.d_inner + 2 * cfg.ssm_state
    return (((B, H, N, P), torch.float32),
            ((B, cfg.ssm_conv - 1, C), DTYPES[cfg.dtype]))


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
    y = r.new_empty((B, L, H, N))
    uu = u[None, :, :, None]
    S = state
    for t in range(L):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]      # (B, H, N, N)
        y[:, t] = torch.matmul(r[:, t, :, None, :], S + uu * kv)[..., 0, :]
        S = w[:, t, :, :, None] * S + kv
    return y, S


def rwkv6_forward(params, x, cfg, state=None):
    """x: (B, L, d); state: (wkv (B, H, N, N) float32, shift (B, 1, d)).
    Returns (y, (wkv, shift)); the new shift is ``x[:, -1:]``."""
    B, L, d = x.shape
    H, N = d // RWKV_HEAD, RWKV_HEAD
    if state is None:
        wkv0 = torch.zeros((B, H, N, N), dtype=torch.float32, device=x.device)
        shift0 = x.new_zeros((B, 1, d))
    else:
        wkv0, shift0 = state
    xr, xk, xv, xw, xg = _rwkv_mix(params, x, shift0)
    r = (xr @ params["wr"]).reshape(B, L, H, N)
    k = (xk @ params["wk"]).reshape(B, L, H, N)
    v = (xv @ params["wv"]).reshape(B, L, H, N)
    g = F.silu(xg @ params["wg"])
    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(xw))), float32
    lora = torch.tanh(xw @ params["w_lora_a"]) @ params["w_lora_b"]
    wlog = params["w0"].float() + lora.float()
    w = torch.exp(-torch.exp(wlog)).reshape(B, L, H, N)
    y, wkv = _rwkv_wkv_scan(r.float(), k.float(), v.float(), w,
                            params["u"].float(), wkv0.float())
    y = y.reshape(B, L, d).to(x.dtype)
    y = rms_norm(y, params["ln_out"]) * g
    return y @ params["w_out"], (wkv, x[:, -1:, :])


def rwkv6_state_specs(cfg, batch: int):
    """((shape, dtype) of wkv, (shape, dtype) of shift) for one layer."""
    d = cfg.d_model
    H, N = d // RWKV_HEAD, RWKV_HEAD
    return (((batch, H, N, N), torch.float32),
            ((batch, 1, d), DTYPES[cfg.dtype]))
