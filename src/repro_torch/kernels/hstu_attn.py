"""HSTU pointwise (SiLU) causal attention — the prefill that makes psi,
and the attention of the training loss.

Replaces the TPU kernel ``src/repro/kernels/hstu_attn.py::hstu_attn``.
On CUDA tensors it launches ``csrc/hstu_rank_attn.cu`` with no prefix and
every query an incremental token (``n_incr = S``), which is exactly the
causal mask; on CPU tensors it runs the plain version (and autograd
differentiates it as it would any PyTorch code).  Any other device
raises.  q, k and v are float32 or bfloat16 alike and the output has
q's type, as the Pallas kernel's does.  ``launches`` counts kernel
launches, and only those.

When autograd records (grad mode on and an input that requires grad), a
CUDA call goes through ``HSTUAttnFunction``: the forward launches the
same kernel, the backward recomputes the scores with ``torch.matmul`` in
float32 and forms dq, dk and dv.  The TPU kernel has no VJP — the
reference differentiates plain jnp attention with XLA — so there is no
backward kernel to port.  With bfloat16 q, k, v the forward launches
the bf16 kernel, and the backward widens the saved inputs and the
incoming gradient to float32, computes there and rounds dq, dk and dv
to bf16 once each.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from . import cuda_lib, ref

launches = 0

# score elements a backward query block may hold (B * H * rows * keys):
# 2**26 float32 is 256 MB, so the few (B, H, rows, keys) temporaries of a
# block stay near 1.5 GB at hstu-gr's B 8, S 4096 (512-row blocks)
BWD_BLOCK_ELEMS = 1 << 26


def hstu_attn_plain(q, k, v, *, n_total: float = None):
    """The plain-PyTorch version: q, k, v (B, H, S, D) -> (B, H, S, D)."""
    return ref.hstu_attn_ref(q, k, v, n_total=n_total)


def _launch(q, k, v, n_total: float):
    global launches
    out = cuda_lib.rank_attn(q, k, v, n_incr=q.shape[2], n_total=n_total)
    launches += 1
    return out


def hstu_attn(q, k, v, *, n_total: float = None):
    """q, k, v: (B, H, S, D) -> (B, H, S, D); ``n_total`` defaults to S."""
    if ref.runs_plain(q):
        return hstu_attn_plain(q, k, v, n_total=n_total)
    n_total = n_total or q.shape[2]
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return HSTUAttnFunction.apply(q, k, v, n_total)
    return _launch(q, k, v, n_total)


def _block_rows(B: int, H: int, S: int) -> int:
    """Query rows per backward block: a multiple of 64 (the kernel's key
    tile) holding at most BWD_BLOCK_ELEMS scores against all S keys."""
    rows = BWD_BLOCK_ELEMS // max(B * H * S, 1) // 64 * 64
    return max(64, min(rows, S))


def hstu_attn_backward(q, k, v, dout, n_total: float):
    """dq, dk, dv of ``out = (causal * silu(q k^T * scale) / n) v``, one
    block of query rows at a time (rows [i0, i1) see keys [0, i1)):

        s  = q k^T * scale            A  = causal * silu(s) / n
        dv = A^T dout                 dA = dout v^T
        ds = dA * causal * silu'(s) / n
        dq = ds k * scale             dk = ds^T q * scale

    with silu'(s) = sig(s) (1 + s (1 - sig(s))).  ``torch.matmul`` in the
    inputs' type (float32 products on the card: the port turns TF32
    off)."""
    B, H, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    rows = _block_rows(B, H, S)
    for i0 in range(0, S, rows):
        i1 = min(i0 + rows, S)
        qb, kb, vb, dob = q[:, :, i0:i1], k[:, :, :i1], v[:, :, :i1], \
            dout[:, :, i0:i1]
        s = torch.matmul(qb, kb.transpose(-1, -2)) * scale  # (B, H, r, i1)
        keep = (torch.arange(i1, device=q.device)[None, :]
                <= torch.arange(i0, i1, device=q.device)[:, None])
        sig = torch.sigmoid(s)
        a = torch.where(keep, s * sig / n_total, 0.0)
        dv[:, :, :i1] += torch.matmul(a.transpose(-1, -2), dob)
        del a
        ds = torch.matmul(dob, vb.transpose(-1, -2))        # dA
        ds = torch.where(keep, ds * (sig * (1 + s * (1 - sig))) / n_total,
                         0.0)
        del s, sig
        dq[:, :, i0:i1] = torch.matmul(ds, kb) * scale
        dk[:, :, :i1] += torch.matmul(ds.transpose(-1, -2), qb) * scale
    return dq, dk, dv


class HSTUAttnFunction(torch.autograd.Function):
    """Causal HSTU attention on the card with a gradient: the forward is
    the CUDA kernel (one counted launch, float32 or bf16 as the inputs),
    the backward ``hstu_attn_backward`` over the saved q, k, v in
    float32 (bf16 inputs widened), its gradients in the inputs' type.
    Under activation checkpointing the forward runs again in the
    backward and launches again."""

    @staticmethod
    def forward(ctx, q, k, v, n_total):
        ctx.save_for_backward(q, k, v)
        ctx.n_total = float(n_total)
        return _launch(q, k, v, n_total)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dt = q.dtype
        with torch.profiler.record_function("hstu_attn_backward"):
            dq, dk, dv = hstu_attn_backward(
                *(t.float() for t in (q, k, v, dout)), ctx.n_total)
        return dq.to(dt), dk.to(dt), dv.to(dt), None
