"""Production meshes and the card's figures (port of
``repro.launch.mesh``).

The meshes are the reference's, by axis names and sizes: one pod
(data 16, model 16) and two pods (pod 2, data 16, model 16), so each
dry-run record pairs with the reference's record of the same name.
They are descriptions (``MeshShape``), not device groups: the port runs
on one card, and the dry-run sizes every step on them without
allocating anything.

The constants price the roofline (``repro_torch.benchmarks.roofline``)
and ``chip_smoke.py``'s bounds.  They are one NVIDIA H100 SXM's
published figures (NVIDIA's H100 data sheet; dense rates, no sparsity,
at the 700 W limit), not measurements.
"""

from __future__ import annotations

from repro_torch.models.partitioning import MeshShape, make_mesh


def make_production_mesh(multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_smoke_mesh() -> MeshShape:
    """One device with the production axis names: one card's sizing."""
    return make_mesh((1, 1), ("data", "model"))


# --- one NVIDIA H100 SXM (NVIDIA's data sheet) ------------------------------
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 / fp16 tensor cores, dense
PEAK_FLOPS_TF32 = 495e12      # FLOP/s, TF32 tensor cores, dense
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12              # B/s, device memory
NVLINK_BW = 450e9             # B/s each way, NVLink 4 (900 GB/s total)
CHIP_HBM_BYTES = 80e9         # device memory


def peak_flops(dtype: str) -> float:
    """The peak a step in ``dtype`` is priced at: bf16 / fp16 on the
    tensor cores; float32 outside them (the port keeps TF32 off)."""
    if dtype in ("bfloat16", "float16"):
        return PEAK_FLOPS_BF16
    if dtype == "float32":
        return PEAK_FLOPS_FP32
    raise ValueError(f"no peak for dtype {dtype!r}")
