"""Logical-axis partitioning rules and the collectives at the reference's
sharding sites (port of ``repro.models.partitioning``).

Model code names the axes of every parameter, batch and cache tensor
with *logical* names ("batch", "heads", "ff", "vocab", "experts", ...).
A rule set maps each logical axis to a mesh axis (or a tuple of them),
and ``Rules.spec`` turns a tensor's logical axes and shape into its
partition spec on a mesh: a tuple with one entry per dimension, a mesh
axis, a tuple of mesh axes, or None (replicated).  ``device_bytes`` is
what one device of the mesh then holds of the tensor.

A mesh is either a description (``MeshShape``: axis names and sizes,
what the dry-run sizes each step on) or a process mesh
(``repro_torch.launch.mesh.ProcessMesh``: one process per device, live
or ``meta``).  Under ``logical_rules(process_mesh)`` every tensor a
rank holds is its shard (``shard``, ``local_shape``): the weights, the
optimizer state, the batch and the caches.  Where the reference's GSPMD
changes a sharding (its ``constrain`` calls), the port's model code
calls the collective that change needs, over one mesh axis:

* ``psum`` / ``pmax``: a sum / max over an axis, no gradient;
* ``enter(x, axis)``: the identity forward, ``psum`` backward: a
  replicated value entering a product sharded on ``axis`` (its gradient
  is partial on each rank);
* ``reduce(x, axis)``: ``psum`` forward, the identity backward: a
  partial sum after a contraction over a sharded axis, whose result is
  replicated (every rank then computes the same loss);
* ``gather(x, axis)``: the shards of ``x`` stacked along a new leading
  dimension, as a zero-padded buffer summed over the axis.

Each is one ``all_reduce`` of the axis's process group (nothing else:
gloo, which a shared card needs, takes CUDA tensors for ``all_reduce``
and ``broadcast`` only), counted by kind, axis and bytes on the mesh
(``ProcessMesh.collectives``).  On an axis of size 1, or outside a
process mesh, each is the identity and counts nothing, so one card runs
the code it always ran.  ``constrain`` stays the identity on values.

FSDP-style weight sharding (ZeRO-3 on the "data" axis) is switched per
mesh by ``fsdp=True``: every weight's "embed" axis is sharded over
"data".  The dry-run sizes it; the model code refuses it under a
process mesh of more than one device (ROADMAP Queue 1, item 10).
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
    """The identity on values.  The reference applies a sharding
    constraint inside jit; the port calls the collective such a change
    needs beside it (``reduce``, ``enter``)."""
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


# ---------------------------------------------------------------------------
# Shards: what one rank of a process mesh holds
# ---------------------------------------------------------------------------


def _flat(m) -> Tuple[str, ...]:
    """A spec entry (None, a mesh axis or a tuple of them) as a tuple."""
    if m is None:
        return ()
    return m if isinstance(m, tuple) else (m,)


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor under
    ``spec``: each sharded dimension divided by its axes' sizes."""
    return tuple(n // math.prod(mesh.shape[a] for a in _flat(m))
                 for n, m in zip(shape, spec))


def shard_slices(shape, spec, mesh, coords=None) -> Tuple[slice, ...]:
    """The slice of each dimension that the device at ``coords`` ({axis:
    coordinate}, by default the mesh's own rank's) holds; a dimension
    over several axes is cut major to minor, as ``jax.sharding`` does."""
    coords = mesh.coords if coords is None else coords
    out = []
    for n, m in zip(shape, spec):
        c, k = 0, 1
        for a in _flat(m):
            c, k = c * mesh.shape[a] + coords[a], k * mesh.shape[a]
        out.append(slice(c * (n // k), (c + 1) * (n // k)))
    return tuple(out)


def _rules_or_raise() -> Rules:
    rules = current_rules()
    if rules is None:
        raise ValueError("no partitioning rules: run under logical_rules()")
    return rules


def shard(x, logical: Sequence[Optional[str]], rules: Rules = None):
    """The rank's shard of a full tensor ``x`` (torch or numpy) whose
    dimensions have the logical names ``logical``, under ``rules`` (the
    current ones by default).  The identity without a process mesh."""
    rules = rules or _rules_or_raise()
    if not is_process_mesh(rules.mesh):
        return x
    spec = rules.spec(logical, shape=tuple(x.shape))
    return x[shard_slices(tuple(x.shape), spec, rules.mesh)]


def shard_tree(tree, axes, rules: Rules = None):
    """``shard`` over parallel trees of full tensors and logical axes
    (dicts and tuples; a None axes leaf replicates)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, axes[k], rules) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(shard_tree(v, a, rules) for v, a in zip(tree, axes))
    if axes is None:
        return tree
    return shard(tree, axes, rules)


def shard_batch(batch, axes, rules: Rules = None):
    """The rank's rows of a global batch ({name: tensor}) under its
    logical axes (``model.batch_axes(shape)``).  The port shards a batch
    evenly over the batch axes: a batch they do not divide raises (the
    reference would replicate it)."""
    rules = rules or _rules_or_raise()
    for k, v in batch.items():
        ax = axes[k]
        if ax and ax[0] == "batch" and is_process_mesh(rules.mesh):
            n = rules.axis_size(rules.table.get("batch"))
            if v.shape[0] % n:
                raise ValueError(f"batch {k!r}: {v.shape[0]} rows do not "
                                 f"split over the {n} devices of the "
                                 f"batch axes")
    return shard_tree(batch, axes, rules)


def local_spec_tree(specs, axes, rules: Rules = None):
    """A (shape, dtype) tree as one rank's shards (``local_shape``): the
    stand-ins of a step's arguments under a process mesh."""
    rules = rules or current_rules()
    if rules is None or rules.mesh is None:
        return specs

    def one(ax, sd):
        return (local_shape(sd[0], rules.spec(ax, shape=sd[0]), rules.mesh),
                sd[1])
    return map_specs(one, axes, specs)


# ---------------------------------------------------------------------------
# Collectives over one mesh axis (all of them one all_reduce)
# ---------------------------------------------------------------------------

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def is_process_mesh(mesh) -> bool:
    """A mesh whose devices are processes (``launch.mesh.ProcessMesh``),
    not a description."""
    return hasattr(mesh, "all_reduce")


def active_axes(axis) -> Tuple[str, ...]:
    """The axes of ``axis`` (a mesh axis, a tuple of them, or None) that
    a collective runs over under the current rules: those of a process
    mesh with more than one device.  Empty outside a process mesh."""
    rules = current_rules()
    mesh = rules.mesh if rules is not None else None
    if mesh is None or mesh.size == 1:
        return ()
    if not is_process_mesh(mesh):
        raise TypeError(f"model code ran under a {type(mesh).__name__} of "
                        f"{mesh.size} devices: it runs under a ProcessMesh")
    return tuple(a for a in _flat(axis) if mesh.shape.get(a, 1) > 1)


def axis_index(axis) -> int:
    """This rank's coordinate along ``axis`` (a tuple flattened major to
    minor); 0 outside a process mesh."""
    axes = active_axes(axis)
    if not axes:
        return 0
    mesh = current_rules().mesh
    c = 0
    for a in axes:
        c = c * mesh.shape[a] + mesh.coords[a]
    return c


def axis_size(axis) -> int:
    """The number of devices along ``axis`` under a process mesh."""
    axes = active_axes(axis)
    return math.prod(current_rules().mesh.shape[a] for a in axes) if axes \
        else 1


def sharded_axis(local_n: int, global_n: int, logical: str):
    """The mesh axis that cut a dimension of ``global_n`` (logical name
    ``logical``) to this rank's ``local_n``, or None where it is whole."""
    rules = current_rules()
    if local_n == global_n or rules is None or not is_process_mesh(
            rules.mesh):
        return None
    m = rules.table.get(logical)
    if m is None or global_n != local_n * axis_size(m):
        raise ValueError(f"{logical}: {local_n} of {global_n} on this rank, "
                         f"which the rules ({m}) do not give")
    return m


def _all_reduce(x, axis, op: str, kind: str = "all-reduce"):
    axes = active_axes(axis)
    if not axes:
        return x
    return current_rules().mesh.all_reduce(x, axes, op, kind)


def psum(x, axis):
    """The sum of ``x`` over the ranks of ``axis`` (no gradient)."""
    return _all_reduce(x, axis, "sum")


def pmax(x, axis):
    """The elementwise max of ``x`` over the ranks of ``axis`` (no
    gradient)."""
    return _all_reduce(x, axis, "max")


# The Functions keep the mesh and the axes they ran over: a CUDA backward
# runs on autograd's own thread, which does not see the caller's rules.


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.mesh, ctx.axes = current_rules().mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axes, "sum"), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        return current_rules().mesh.all_reduce(x, axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter(x, axis):
    """The identity forward and ``psum`` over ``axis`` backward: where a
    value replicated over ``axis`` enters a computation sharded on it,
    so that each rank's partial gradient becomes the whole one."""
    axes = active_axes(axis)
    return _Enter.apply(x, axes) if axes else x


def reduce(x, axis):
    """``psum`` over ``axis`` forward and the identity backward: where
    a contraction over a sharded dimension leaves a partial sum on each
    rank and its replicated result goes on (the reference's
    ``constrain(..., ("batch", "seq", "embed"))`` after it).  Not
    ``torch.distributed.nn.functional.all_reduce``, whose backward sums
    again and multiplies every upstream gradient by the axis size when
    the loss is replicated."""
    axes = active_axes(axis)
    return _Reduce.apply(x, axes) if axes else x


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.index = axis_index(axis)
        buf = x.new_zeros((axis_size(axis),) + tuple(x.shape))
        buf[ctx.index] = x
        return current_rules().mesh.all_reduce(buf, active_axes(axis), "sum",
                                               "all-gather")

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None


def gather(x, axis):
    """(n, *x.shape): every rank's ``x`` along ``axis`` in coordinate
    order, as one all-reduce of a zero buffer holding this rank's row
    (x + 0 is exact); counted as an all-gather.  The gradient of the
    result is taken as replicated over ``axis``: each rank keeps its
    own row of it."""
    return _Gather.apply(x, axis) if active_axes(axis) else x[None]


@contextlib.contextmanager
def _rules_as(rules: Optional[Rules]):
    prev = getattr(_tls, "rules", None)
    _tls.rules = rules
    try:
        yield rules
    finally:
        _tls.rules = prev


def checkpoint_in_rules(fn, *args):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn(*args)`` whose
    recompute runs under the rules of the forward: on a CUDA model the
    backward, and so the recompute, runs on autograd's thread, which
    would otherwise see no rules and skip the collectives."""
    from torch.utils.checkpoint import checkpoint
    rules = current_rules()
    return checkpoint(fn, *args, use_reentrant=False, context_fn=lambda: (
        contextlib.nullcontext(), _rules_as(rules)))


def batch_axis():
    """The mesh axes the "batch" logical axis maps to."""
    rules = current_rules()
    return rules.table.get("batch") if rules is not None else None


def refuse_under_mesh(what: str, item: str):
    """Raise ``ValueError`` for a path the port does not run under a
    process mesh of more than one device (``item`` names the ROADMAP
    entry that ports it)."""
    rules = current_rules()
    if rules is not None and rules.mesh is not None and rules.mesh.size > 1:
        raise ValueError(f"{what} does not run under a mesh of "
                         f"{rules.mesh.size} devices yet ({item})")
