"""Mamba2 SSD chunk stages — the two matmul-heavy parts of chunked SSD.

Replaces the TPU kernels of ``src/repro/kernels/ssd_chunk.py``:

* ``ssd_chunk_intra`` — the intra-chunk masked decay contraction
  ``y[q] = sum_{t <= q} exp(cum[q] - cum[t]) (C[q] . B[t]) dt[t] x[t]``;
* ``ssd_chunk_state`` — each chunk's state summary
  ``S = sum_t exp(cum[-1] - cum[t]) dt[t] B[t] (x) x[t]``.

Shapes: Cc, Bc (B, nc, Q, N); xc (B, nc, Q, H, P); cum, dtc
(B, nc, Q, H); Q <= 128.  On CUDA tensors each wrapper launches
``csrc/ssd_chunk.cu`` (float32 only, as on the model's path, where
``mamba2_forward`` casts x, B and C to float32 first); on CPU tensors it
runs the plain twin.  Any other device raises.  ``launches_intra`` and
``launches_state`` count kernel launches, and only those.
"""

from __future__ import annotations

import torch

from . import cuda_lib

launches_intra = 0
launches_state = 0


def ssd_chunk_intra_ref(Cc, Bc, xc, cum, dtc):
    """Plain twin (mirrors ``repro``'s ``ssd_chunk_intra_ref``):
    computed in float32, returned in xc's type."""
    Q = Cc.shape[2]
    scores = torch.einsum("bcqn,bckn->bcqk", Cc.float(), Bc.float())
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=Cc.device).tril()
    M = torch.where(causal[None, None, :, :, None], torch.exp(dec), 0.0)
    Mx = M * scores[..., None] * dtc[:, :, None, :, :]
    return torch.einsum("bcqkh,bckhp->bcqhp", Mx,
                        xc.float()).to(xc.dtype)


def ssd_chunk_state_ref(Bc, xc, cum, dtc):
    """Plain twin (mirrors ``repro``'s ``ssd_chunk_state_ref``):
    (B, nc, H, N, P) float32."""
    tail = cum[:, :, -1:, :] - cum
    return torch.einsum("bcqn,bcqh,bcqhp->bchnp", Bc.float(),
                        torch.exp(tail) * dtc, xc.float())


def ssd_chunk_intra(Cc, Bc, xc, cum, dtc):
    """y_intra (B, nc, Q, H, P)."""
    global launches_intra
    if xc.device.type == "cpu":
        return ssd_chunk_intra_ref(Cc, Bc, xc, cum, dtc)
    out = cuda_lib.ssd_chunk("intra", Cc, Bc, xc, cum, dtc)
    launches_intra += 1
    return out


def ssd_chunk_state(Bc, xc, cum, dtc):
    """Per-chunk states (B, nc, H, N, P) float32."""
    global launches_state
    if xc.device.type == "cpu":
        return ssd_chunk_state_ref(Bc, xc, cum, dtc)
    out = cuda_lib.ssd_chunk("state", None, Bc, xc, cum, dtc)
    launches_state += 1
    return out
