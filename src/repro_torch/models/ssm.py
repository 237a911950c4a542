"""Mamba2 (SSD) in PyTorch (port of the Mamba2 half of ``repro.models.ssm``).

The chunked SSD formulation: within a chunk of ``MAMBA_CHUNK`` tokens the
work is two masked contractions, and only the recurrence across chunks
is sequential.  The two contractions are the kernels of
``repro_torch.kernels.ssd_chunk`` — ``ssd_chunk_intra`` (the intra-chunk
term) and ``ssd_chunk_state`` (each chunk's state summary) — which
launch CUDA on CUDA tensors and run their plain twins on the CPU.  The
inter-chunk recurrence and ``y_inter`` stay plain PyTorch in float32.

The recurrent state (``ssm`` (B, H, N, P) float32, ``conv`` (B, K-1, C))
is the decode cache.  RWKV6 is not ported yet.
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
