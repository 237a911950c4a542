"""Production meshes and the card's figures (port of
``repro.launch.mesh``).

The meshes are the reference's, by axis names and sizes: one pod
(data 16, model 16) and two pods (pod 2, data 16, model 16), so each
dry-run record pairs with the reference's record of the same name.
They are descriptions (``MeshShape``): the dry-run sizes every step on
them without allocating anything.

``ProcessMesh`` is a mesh of processes, one per device, with the
reference's axis names: live over ``torch.distributed`` (NCCL, or gloo
for ranks that share a card or run on the CPU), or ``meta`` (a rank's
coordinates and no process group: the dry-run traces one rank's step
and counts its collectives).

The constants price the roofline (``repro_torch.benchmarks.roofline``)
and ``chip_smoke.py``'s bounds.  They are one NVIDIA H100 SXM's
published figures (NVIDIA's H100 data sheet; dense rates, no sparsity,
at the 700 W limit), not measurements.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Dict, List, Sequence, Tuple

from repro_torch.models.partitioning import (COLLECTIVES, MeshShape,
                                             make_mesh)

BACKENDS = ("nccl", "gloo")


def make_production_mesh(multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_smoke_mesh() -> MeshShape:
    """One device with the production axis names: one card's sizing."""
    return make_mesh((1, 1), ("data", "model"))


def axis_groups(sizes: Sequence[int], axis_names: Sequence[str],
                axes: Sequence[str]) -> List[List[int]]:
    """The process groups of a reduction over ``axes`` on a mesh of
    ``sizes`` laid out row-major over the ranks: for every coordinate
    off ``axes``, the ranks that vary over them, in rank order."""
    coords = list(itertools.product(*(range(n) for n in sizes)))
    off = [i for i, a in enumerate(axis_names) if a not in axes]
    groups: Dict[tuple, List[int]] = {}
    for r, c in enumerate(coords):
        groups.setdefault(tuple(c[i] for i in off), []).append(r)
    return list(groups.values())


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh(MeshShape):
    """A (data, model)-style mesh of processes: a ``MeshShape`` (so
    ``Rules``, ``Rules.spec`` and ``device_bytes`` take it) that knows
    this rank's coordinate on every axis (``coords``, row-major over
    the ranks as ``init_device_mesh`` lays them out).

    ``ProcessMesh.init`` joins a live process group and wraps
    ``torch.distributed.device_mesh.init_device_mesh``; ``ProcessMesh.
    meta`` has coordinates and no group.  ``backend`` is the caller's
    choice, never a fallback: "nccl" (one card a rank) or "gloo" (CUDA
    or CPU tensors; ranks may share a card: gloo takes CUDA tensors for
    ``all_reduce``, the one collective the port calls).

    Every ``all_reduce`` is one collective, over one process group (a
    reduction over several axes has a group of its own, made at
    ``init``), and is counted in ``tally`` by (kind, axes): {"count",
    "bytes"}, the bytes of the reduced buffer (the output, as the
    reference counts an HLO collective); ``collectives()`` sums it by
    kind in the reference's record layout."""
    rank: int = 0
    device_mesh: object = None
    groups: Dict[Tuple[str, ...], object] = dataclasses.field(
        default_factory=dict)
    tally: Dict[Tuple[str, Tuple[str, ...]], Dict[str, int]] = \
        dataclasses.field(default_factory=dict)

    def __post_init__(self):
        super().__post_init__()
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a mesh of "
                             f"{self.size}")

    @functools.cached_property
    def coords(self) -> Dict[str, int]:
        coords, r = {}, self.rank
        for a, n in reversed(list(zip(self.axis_names, self.sizes))):
            coords[a], r = r % n, r // n
        return {a: coords[a] for a in self.axis_names}

    @classmethod
    def meta(cls, sizes, axis_names=("data", "model"), rank: int = 0):
        """No process group: the collectives count and return their
        input (the dry-run's trace of rank ``rank``)."""
        return cls(tuple(axis_names), tuple(int(s) for s in sizes), rank)

    @classmethod
    def init(cls, sizes, axis_names=("data", "model"), *, backend: str,
             init_method: str, rank: int, world_size: int):
        """Join the process group (``init_method`` such as
        ``file:///tmp/store`` or ``tcp://localhost:port``) as ``rank`` of
        ``world_size`` and lay it out as a mesh of ``sizes``; every
        rank makes the groups of the reductions over several axes."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        if math.prod(sizes) != world_size:
            raise ValueError(f"a {tuple(sizes)} mesh for {world_size} ranks")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        if not dist.is_initialized():
            dist.init_process_group(backend, init_method=init_method,
                                    rank=rank, world_size=world_size)
        axis_names = tuple(axis_names)
        dm = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                              tuple(sizes), mesh_dim_names=axis_names)
        groups = {}
        for n in range(2, len(axis_names) + 1):
            for axes in itertools.combinations(axis_names, n):
                for ranks in axis_groups(sizes, axis_names, axes):
                    g = dist.new_group(ranks)     # every rank, every group
                    if rank in ranks:
                        groups[axes] = g
        mesh = cls(axis_names, tuple(int(s) for s in sizes), rank, dm,
                   groups)
        if [mesh.coords[a] for a in mesh.axis_names] != list(
                dm.get_coordinate()):
            raise RuntimeError(f"rank {rank}: coordinates {mesh.coords} != "
                               f"the device mesh's {dm.get_coordinate()}")
        return mesh

    @property
    def is_meta(self) -> bool:
        return self.device_mesh is None

    def all_reduce(self, x, axes: Tuple[str, ...], op: str = "sum",
                   kind: str = "all-reduce"):
        """A new tensor: ``x`` reduced (``op`` "sum" or "max") over the
        ranks that share this rank's coordinates off ``axes``, in one
        collective; counted once under ``kind``."""
        axes = tuple(a for a in self.axis_names if a in axes)
        rec = self.tally.setdefault((kind, axes), {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += x.numel() * x.element_size()
        y = x.detach().clone()
        if self.is_meta or y.device.type == "meta":
            return y
        import torch.distributed as dist
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        group = (self.device_mesh.get_group(axes[0]) if len(axes) == 1
                 else self.groups[axes])
        dist.all_reduce(y, rop, group=group)
        return y

    def reset_tally(self):
        self.tally.clear()

    def collectives(self) -> dict:
        """The tally by kind, the reference's dry-run record layout:
        {kind: {"count", "bytes"}, ..., "total_bytes"}."""
        out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
        for (kind, _), rec in self.tally.items():
            out[kind]["count"] += rec["count"]
            out[kind]["bytes"] += rec["bytes"]
        out["total_bytes"] = sum(v["bytes"] for v in out.values())
        return out


def destroy():
    """Leave the process group (a rank's last call)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


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
