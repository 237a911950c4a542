"""RelayGR in PyTorch for NVIDIA Hopper — the port of ``repro``.

Mirrors ``repro``'s module tree: the numpy-only relay core is carried over
as copies, the HSTU model and the live executors are PyTorch, and the
seven TPU kernels are CUDA C++ written for ``sm_90a``
(``repro_torch/csrc``), each with a plain-PyTorch twin in its module:
the four HSTU attention kernels of the relay path (causal prefill, rank
with cache, paged rank, segment rank), the flash decode, and the two
Mamba2 SSD chunk stages.  Each takes float32 or bfloat16, as the Pallas
kernel it replaces does.  The package imports ``torch`` and ``numpy`` only, never JAX and
nothing of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA on a machine without it raises instead of falling back.
``device="meta"`` builds shapes only (the dry-run,
``repro_torch.launch.dryrun``): nothing is allocated or computed.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on: ``cuda``, ``cpu``, or
    ``meta`` (shapes without storage, for the dry-run's accounting).
    Raises when CUDA is asked for and absent: the port never carries on
    silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
