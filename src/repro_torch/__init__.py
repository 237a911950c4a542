"""RelayGR in PyTorch for NVIDIA Hopper — the port of ``repro``.

Mirrors ``repro``'s module tree: the numpy-only relay core is carried over
as copies, the HSTU model and the live executors are PyTorch, and the
three attention kernels of the relay path (causal prefill, rank with
cache, paged rank) are CUDA C++ written for ``sm_90a``
(``repro_torch/csrc``), each with a plain-PyTorch twin in the same
module.  The package imports ``torch`` and ``numpy`` only, never JAX and
nothing of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA on a machine without it raises instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.  Raises when CUDA is
    asked for and absent: the port never carries on silently on the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
