"""Mamba2 SSD chunk stages — the two matmul-heavy parts of chunked SSD.

Replaces the TPU kernels of ``src/repro/kernels/ssd_chunk.py``:

* ``ssd_chunk_intra`` — the intra-chunk masked decay contraction
  ``y[q] = sum_{t <= q} exp(cum[q] - cum[t]) (C[q] . B[t]) dt[t] x[t]``;
* ``ssd_chunk_state`` — each chunk's state summary
  ``S = sum_t exp(cum[-1] - cum[t]) dt[t] B[t] (x) x[t]``.

Shapes: Cc, Bc (B, nc, Q, N); xc (B, nc, Q, H, P); cum, dtc
(B, nc, Q, H); Q <= 128.  Types: C, B and x float32 or bfloat16 alike
(the model hands over bf16 slices of its xBC as they are), cum and dt
float32, every sum in float32, as the Pallas kernels widen on load.
``ssd_chunk_intra`` returns xc's type, as the Pallas kernel does, or the
``out_dtype`` asked for (the model asks for float32); ``ssd_chunk_state``
returns float32.  On CUDA tensors each wrapper launches
``csrc/ssd_chunk.cu``; on CPU tensors it runs the plain twin.  Any other
device raises.  ``launches_intra`` and ``launches_state`` count kernel
launches, and only those.

Gradients.  On a CUDA tensor every call goes through
``SSDChunkIntraFunction`` / ``SSDChunkStateFunction``, in grad mode or
not: the forward is the counted kernel launch, the backward
``ssd_chunk_intra_backward`` / ``ssd_chunk_state_backward``, the closed
forms of the gradients with respect to all five (four) inputs, written
in float32 torch ops over every chunk at once and returned in each
input's type.  The backward launches no kernel
(the TPU kernels have no VJP: the reference differentiates the plain
jnp SSD), so under per-layer activation checkpointing a training step
counts two launches of each kernel a Mamba2 layer: the forward and its
recompute.  On the CPU the twins are plain PyTorch and autograd
differentiates them as it would any code.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import cuda_lib, ref

launches_intra = 0
launches_state = 0


def ssd_chunk_intra_ref(Cc, Bc, xc, cum, dtc, out_dtype=None):
    """Plain twin (mirrors ``repro``'s ``ssd_chunk_intra_ref``):
    computed in float32, returned in ``out_dtype`` (xc's type by
    default).  The decay is
    exponentiated under the causal mask (masked entries as exp(0)), so
    no masked exp(cum[q] - cum[t] > 88) overflows: the same values as
    the reference's ``where(causal, exp(dec), 0)``, and a finite
    gradient where the reference's is NaN (ROADMAP Queue 3, item 24)."""
    Q = Cc.shape[2]
    scores = torch.einsum("bcqn,bckn->bcqk", Cc.float(), Bc.float())
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=Cc.device).tril()[None, None, :, :, None]
    M = torch.where(causal, torch.exp(torch.where(causal, dec, 0.0)), 0.0)
    Mx = M * scores[..., None] * dtc[:, :, None, :, :]
    return torch.einsum("bcqkh,bckhp->bcqhp", Mx,
                        xc.float()).to(out_dtype or xc.dtype)


def ssd_chunk_state_ref(Bc, xc, cum, dtc):
    """Plain twin (mirrors ``repro``'s ``ssd_chunk_state_ref``):
    (B, nc, H, N, P) float32."""
    tail = cum[:, :, -1:, :] - cum
    return torch.einsum("bcqn,bcqh,bcqhp->bchnp", Bc.float(),
                        torch.exp(tail) * dtc, xc.float())


def _launch_intra(Cc, Bc, xc, cum, dtc, out_dtype=None):
    global launches_intra
    out = cuda_lib.ssd_chunk("intra", Cc, Bc, xc, cum, dtc,
                             out_dtype=out_dtype)
    launches_intra += 1
    return out


def _launch_state(Bc, xc, cum, dtc):
    global launches_state
    out = cuda_lib.ssd_chunk("state", None, Bc, xc, cum, dtc)
    launches_state += 1
    return out


def ssd_chunk_intra(Cc, Bc, xc, cum, dtc, out_dtype=None):
    """y_intra (B, nc, Q, H, P) in ``out_dtype``, xc's type by default."""
    if ref.runs_plain(xc):
        return ssd_chunk_intra_ref(Cc, Bc, xc, cum, dtc, out_dtype)
    return SSDChunkIntraFunction.apply(Cc, Bc, xc, cum, dtc, out_dtype)


def ssd_chunk_state(Bc, xc, cum, dtc):
    """Per-chunk states (B, nc, H, N, P) float32."""
    if ref.runs_plain(xc):
        return ssd_chunk_state_ref(Bc, xc, cum, dtc)
    return SSDChunkStateFunction.apply(Bc, xc, cum, dtc)


def _wide(*ts):
    """The type the backward computes in: float32, or float64 if any
    input is."""
    return torch.float64 if any(t.dtype == torch.float64 for t in ts) \
        else torch.float32


def _as_inputs(grads, inputs):
    """Each gradient in its input's type (a bf16 input's float32
    gradient rounded once, as the gradient through a float32 copy of it
    would be)."""
    return tuple(g.to(t.dtype) for g, t in zip(grads, inputs))


def ssd_chunk_intra_backward(Cc, Bc, xc, cum, dtc, dy):
    """(dC, dB, dx, dcum, ddt) of ``ssd_chunk_intra``'s output against
    ``dy`` (B, nc, Q, H, P), every chunk at once, heads leading:

        W[q,t,h] = 1[t <= q] exp(cum[q,h] - cum[t,h])
        s[q,t]   = C[q] . B[t]            M = W s dt[t]  (y = M x)
        G[q,t,h] = sum_p dy[q,h,p] x[t,h,p]
        dx[t,h]  = sum_q M[q,t,h] dy[q,h]
        ds[q,t]  = sum_h W dt[t,h] G      dC = ds B,  dB = ds^T C
        ddt[t,h] = sum_q W s G
        E = M G:  dcum[q,h] = sum_t E[q,t,h] - sum_t E[t,q,h]

    The (B, nc, H, Q, Q) temporaries are 268 MB each in float32 at B 2 x
    4096 tokens, H 64, Q 128."""
    wt = _wide(Cc, Bc, xc, cum, dtc, dy)
    C, Bm = Cc.to(wt), Bc.to(wt)
    x = xc.to(wt).permute(0, 1, 3, 2, 4)                  # (B, nc, H, Q, P)
    g = dy.to(wt).permute(0, 1, 3, 2, 4)
    cT = cum.to(wt).transpose(2, 3)                       # (B, nc, H, Q)
    dt = dtc.to(wt).transpose(2, 3)[..., None, :]         # (.., H, 1, t)
    Q = C.shape[2]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=C.device).tril()
    W = torch.where(causal, torch.exp(torch.where(
        causal, cT[..., :, None] - cT[..., None, :], 0.0)), 0.0)
    s = torch.matmul(C, Bm.transpose(-1, -2))[:, :, None]  # (B, nc, 1, q, t)
    G = torch.matmul(g, x.transpose(-1, -2))              # (B, nc, H, q, t)
    Wdt = W * dt
    dx = torch.matmul((Wdt * s).transpose(-1, -2), g)     # (B, nc, H, t, P)
    WdtG = Wdt * G
    ds = WdtG.sum(2)                                      # (B, nc, q, t)
    dC = torch.matmul(ds, Bm)
    dB = torch.matmul(ds.transpose(-1, -2), C)
    del Wdt, ds
    WG = W * G
    del W, G
    sWG = WG * s                                          # W s G
    ddt = sWG.sum(3)                                      # (B, nc, H, t)
    E = sWG * dt
    dcum = E.sum(4) - E.sum(3)                            # (B, nc, H, q)
    return (dC, dB, dx.permute(0, 1, 3, 2, 4), dcum.transpose(2, 3),
            ddt.transpose(2, 3))


def ssd_chunk_state_backward(Bc, xc, cum, dtc, dS):
    """(dB, dx, dcum, ddt) of ``ssd_chunk_state``'s output against
    ``dS`` (B, nc, H, N, P), every chunk at once:

        w[t,h]  = exp(cum[last,h] - cum[t,h]) dt[t,h]
        BdS     = B[t] . dS[h]  (over N)       dx = w BdS
        dB[t]   = sum_h w (x[t,h] . dS[h]^T)   (over P)
        g[t,h]  = sum_p x[t,h,p] BdS[t,h,p]
        ddt     = exp(cum[last] - cum) g
        dcum[t] = -w g, and dcum[last] += sum_t w g"""
    wt = _wide(Bc, xc, cum, dtc, dS)
    Bm, x, c, dt, dS = (t.to(wt) for t in (Bc, xc, cum, dtc, dS))
    Bn, nc, Q, H, P = x.shape
    N = Bm.shape[3]
    e = torch.exp(c[:, :, -1:, :] - c)                    # (B, nc, Q, H)
    w = e * dt
    dSn = dS.permute(0, 1, 3, 2, 4).reshape(Bn, nc, N, H * P)
    BdS = torch.matmul(Bm, dSn).view(Bn, nc, Q, H, P)
    dx = w[..., None] * BdS
    gsum = (x * BdS).sum(-1)                              # (B, nc, Q, H)
    dB = torch.matmul((w[..., None] * x).reshape(Bn, nc, Q, H * P),
                      dSn.transpose(-1, -2))
    ddt = e * gsum
    wg = w * gsum
    dcum = -wg
    dcum[:, :, -1] += wg.sum(2)
    return dB, dx, dcum, ddt


class SSDChunkIntraFunction(torch.autograd.Function):
    """``ssd_chunk_intra`` on the card with a gradient: the forward is
    the CUDA kernel (one counted launch), the backward
    ``ssd_chunk_intra_backward`` over the saved inputs, each gradient in
    its input's type."""

    @staticmethod
    def forward(ctx, Cc, Bc, xc, cum, dtc, out_dtype=None):
        ctx.save_for_backward(Cc, Bc, xc, cum, dtc)
        return _launch_intra(Cc, Bc, xc, cum, dtc, out_dtype=out_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        ins = ctx.saved_tensors
        with torch.profiler.record_function("ssd_chunk_intra_backward"):
            return (*_as_inputs(ssd_chunk_intra_backward(*ins, dy), ins),
                    None)


class SSDChunkStateFunction(torch.autograd.Function):
    """``ssd_chunk_state`` on the card with a gradient: the forward is
    the CUDA kernel (one counted launch), the backward
    ``ssd_chunk_state_backward`` over the saved inputs, each gradient in
    its input's type."""

    @staticmethod
    def forward(ctx, Bc, xc, cum, dtc):
        ctx.save_for_backward(Bc, xc, cum, dtc)
        return _launch_state(Bc, xc, cum, dtc)

    @staticmethod
    @once_differentiable
    def backward(ctx, dS):
        ins = ctx.saved_tensors
        with torch.profiler.record_function("ssd_chunk_state_backward"):
            return _as_inputs(ssd_chunk_state_backward(*ins, dS), ins)
