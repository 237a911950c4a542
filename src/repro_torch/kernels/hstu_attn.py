"""HSTU pointwise (SiLU) causal attention — the prefill that makes psi.

Replaces the TPU kernel ``src/repro/kernels/hstu_attn.py::hstu_attn``.
On CUDA tensors it launches ``csrc/hstu_rank_attn.cu`` with no prefix and
every query an incremental token (``n_incr = S``), which is exactly the
causal mask; on CPU tensors it runs the plain version.  Any other device
raises.  ``launches`` counts kernel launches, and only those.
"""

from __future__ import annotations

from . import cuda_lib, ref

launches = 0


def hstu_attn_plain(q, k, v, *, n_total: float = None):
    """The plain-PyTorch version: q, k, v (B, H, S, D) -> (B, H, S, D)."""
    return ref.hstu_attn_ref(q, k, v, n_total=n_total)


def hstu_attn(q, k, v, *, n_total: float = None):
    """q, k, v: (B, H, S, D) -> (B, H, S, D); ``n_total`` defaults to S."""
    global launches
    if q.device.type == "cpu":
        return hstu_attn_plain(q, k, v, n_total=n_total)
    S = q.shape[2]
    out = cuda_lib.rank_attn(q, k, v, n_incr=S, n_total=n_total or S)
    launches += 1
    return out
