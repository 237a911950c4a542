"""Logical-axis partitioning rules (port of ``repro.models.partitioning``).

Model code names the axes of every parameter, batch and cache tensor
with *logical* names ("batch", "heads", "ff", "vocab", "experts", ...).
A rule set maps each logical axis to a mesh axis (or a tuple of them),
and ``Rules.spec`` turns a tensor's logical axes and shape into its
partition spec on a mesh: a tuple with one entry per dimension, a mesh
axis, a tuple of mesh axes, or None (replicated).  ``device_bytes`` is
what one device of the mesh then holds of the tensor.

The port runs on one card, so nothing here shards a tensor: a mesh is a
plain description (``MeshShape``: axis names and sizes), used by the
dry-run (``repro_torch.launch.dryrun``) to size each step on the
reference's meshes.  ``constrain`` is the identity, and no model code
calls it.

FSDP-style weight sharding (ZeRO-3 on the "data" axis) is switched per
mesh by ``fsdp=True``: every weight's "embed" axis is sharded over
"data".
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

_tls = threading.local()

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "heads": "model",
    "kv_heads": "model",      # dropped per arch when not divisible
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "embed": None,            # becomes "data" under fsdp
    "opt_data": "data",       # ZeRO-2: optimizer-state-only sharding
    "kv_seq": None,           # long-context decode shards cache seq on data
    "seq": None,
    "ssm_heads": "model",
    "rwkv_heads": "model",
    "ssm_state": None,
    "frames": None,
}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A device mesh as ``Rules`` reads one: its axis names and, by name,
    their sizes (``shape``, as ``jax.sharding.Mesh.shape``)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        """``16x16``, ``2x16x16``: the reference's record names."""
        return "x".join(str(s) for s in self.sizes)


def make_mesh(sizes: Sequence[int], axis_names: Sequence[str]) -> MeshShape:
    """The counterpart of ``jax.make_mesh(shape, axes)``."""
    return MeshShape(tuple(axis_names), tuple(int(s) for s in sizes))


class Rules:
    def __init__(self, mesh: Optional[MeshShape], overrides=None,
                 fsdp: bool = False):
        self.mesh = mesh
        self.fsdp = fsdp
        self.table = dict(DEFAULT_RULES)
        if overrides:
            self.table.update(overrides)
        if fsdp:
            self.table["embed"] = "data"
        if mesh is not None:
            names = set(mesh.axis_names)
            resolved = {}
            for k, v in self.table.items():
                if v is None or v == "":
                    resolved[k] = None
                elif isinstance(v, tuple):
                    kept = tuple(a for a in v if a in names)
                    resolved[k] = kept if kept else None
                else:
                    resolved[k] = v if v in names else None
            self.table = resolved

    def axis_size(self, mesh_axis) -> int:
        if self.mesh is None or mesh_axis is None:
            return 1
        if isinstance(mesh_axis, tuple):
            return math.prod(self.mesh.shape[a] for a in mesh_axis)
        return self.mesh.shape[mesh_axis]

    def spec(self, logical: Sequence[Optional[str]], shape=None) -> tuple:
        """Map logical axis names to a partition spec (a tuple, one entry
        per dimension).

        If ``shape`` is given, an axis whose size the mesh-axis size does
        not divide is replicated (None): 36 attention heads on a 16-way
        model axis degrade to replicated attention.  A mesh axis appears
        at most once in a spec: a later dimension that would reuse one is
        replicated."""
        out = []
        used = set()
        for i, name in enumerate(logical):
            m = self.table.get(name) if name else None
            if m is not None and shape is not None:
                if shape[i] % self.axis_size(m) != 0:
                    m = None
            if m is not None:
                flat = m if isinstance(m, tuple) else (m,)
                if any(a in used for a in flat):
                    m = None
                else:
                    used.update(flat)
            out.append(m)
        return tuple(out)


@contextlib.contextmanager
def logical_rules(mesh: Optional[MeshShape], overrides=None,
                  fsdp: bool = False):
    prev = getattr(_tls, "rules", None)
    _tls.rules = Rules(mesh, overrides, fsdp)
    try:
        yield _tls.rules
    finally:
        _tls.rules = prev


def current_rules() -> Optional[Rules]:
    return getattr(_tls, "rules", None)


def constrain(x, logical: Sequence[Optional[str]]):
    """The identity: one card shards nothing (the reference applies a
    sharding constraint inside jit under a mesh)."""
    return x


def is_axes(x) -> bool:
    """A leaf of an axes tree: a tuple of logical names or None."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def is_spec(x) -> bool:
    """A leaf of a spec tree: ``(shape, torch.dtype)``."""
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[1], torch.dtype))


def map_specs(fn, axes, specs):
    """``fn(axes_leaf, spec_leaf)`` over two parallel trees, an axes
    tree and a spec tree (dicts and tuples), keeping the spec tree's
    nesting."""
    if is_spec(specs):
        if not is_axes(axes) or len(axes) != len(specs[0]):
            raise ValueError(f"axes {axes!r} do not match spec {specs!r}")
        return fn(axes, specs)
    if isinstance(specs, dict):
        if not isinstance(axes, dict) or set(axes) != set(specs):
            raise ValueError(f"axes keys {sorted(axes)} != spec keys "
                             f"{sorted(specs)}")
        return {k: map_specs(fn, axes[k], specs[k]) for k in specs}
    if len(axes) != len(specs):
        raise ValueError(f"{len(axes)} axes for {len(specs)} specs")
    return tuple(map_specs(fn, a, s) for a, s in zip(axes, specs))


def tree_specs(mesh: MeshShape, tree_logical, tree_shapes,
               fsdp: bool = False):
    """The partition spec of every leaf, from parallel trees of logical
    axes and (shape, dtype) specs (the counterpart of the reference's
    ``tree_shardings``)."""
    rules = Rules(mesh, fsdp=fsdp)
    return map_specs(lambda ax, sd: rules.spec(ax, shape=sd[0]),
                     tree_logical, tree_shapes)


def device_bytes(shape, dtype: torch.dtype, spec, mesh: MeshShape) -> int:
    """Bytes of a (shape, dtype) tensor on one device of ``mesh`` under
    ``spec``: the whole tensor over the product of its sharded axes'
    sizes (an exact division: ``Rules.spec`` shards only dimensions the
    axes divide)."""
    n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    shards = 1
    for m in spec:
        if m is not None:
            for a in (m if isinstance(m, tuple) else (m,)):
                shards *= mesh.shape[a]
    return n // shards
