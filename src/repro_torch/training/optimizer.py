"""AdamW + the LR schedule over tensor trees (port of
``repro.training.optimizer``).

Written over the parameter tree, not with ``torch.optim.AdamW``, so the
state layout, the clip and the decay rules are the reference's step for
step:

* the state is ``{"mu": tree, "nu": tree, "step": int32 scalar}`` with
  float32 moments on the parameters' device; ``step`` stays on the host,
  so the schedule and the bias corrections are computed there in
  float32, as the reference computes them, and no step waits on the
  device;
* the gradient is clipped by its global norm (a device scalar), weight
  decay applies to leaves with ndim >= 2 only (the stacked layers' norm
  scales are (L, d), so they decay, as in the reference), and a leaf
  with no gradient counts as a zero gradient, as ``jax.grad`` gives
  one.

``apply_updates`` updates the parameters and the state in place and
returns them, with ``{"grad_norm", "lr"}``.

Under a process mesh every tensor is this rank's shard: the parameters'
and the moments' under the same rules, so AdamW, elementwise, runs on
the shards as they are (FSDP included).  ZeRO-2 (``state_axes(...,
zero2=True)``: the moments' "embed" dimension on "opt_data" -> "data")
cuts the moments finer than the parameters: given the moments' partition
specs beside the parameters', ``init_state`` gives this rank its part of
each moment and ``apply_updates`` updates the matching part of each
parameter (from the replicated gradient's part) and all-gathers the
parameters over "data" (one all-reduce of zero-padded buffers a type),
so that every data rank ends the step with the same bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.models.partitioning import (active_axes, axis_index,
                                             axis_size, gather_sum, psum,
                                             spec_axes)
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine down to ``min_lr_ratio * lr``
    at ``total_steps``; a float32 scalar on the host."""
    step = torch.as_tensor(step, dtype=torch.float32, device="cpu")
    warm = step / max(cfg.warmup_steps, 1)
    prog = ((step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decay)


def init_state(params, specs=None, moment_specs=None) -> Dict[str, Any]:
    """Zero float32 moments beside ``params`` (this rank's shards) and
    step 0.  ``specs`` and ``moment_specs`` (ZeRO-2: the parameters' and
    the moments' partition spec trees under a process mesh): each moment
    is this rank's part of its parameter (``moment_cuts``)."""
    ps = leaves(params)
    cut_of = {id(p): c for p, c in zip(
        ps, moment_cuts(specs, moment_specs, len(ps)))}

    def zeros(p):
        shape = list(p.shape)
        for dim, axes in cut_of[id(p)]:
            shape[dim] //= axis_size(axes)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    mu = tree_map(zeros, params)
    return {"mu": mu, "nu": tree_map(torch.zeros_like, mu),
            "step": torch.zeros((), dtype=torch.int32)}


def moment_cuts(specs, moment_specs, n: int):
    """Per leaf (``tree.leaves`` order; ``n`` of them), the (dimension,
    mesh axes) on which its moments are a part of its parameter: the
    axes of a moment's spec entry that the parameter's entry lacks and
    that have more than one device (ZeRO-2's "data"); () everywhere
    without ``moment_specs``."""
    if moment_specs is None:
        return [()] * n
    out = []
    for ps, ms in zip(leaves_of_specs(specs), leaves_of_specs(moment_specs)):
        cut = []
        for dim, (a, b) in enumerate(zip(ps, ms)):
            extra = tuple(x for x in spec_axes(b) if x not in spec_axes(a))
            if active_axes(extra):
                cut.append((dim, extra))
        out.append(tuple(cut))
    return out


def abstract_state(abstract_params) -> Dict[str, Any]:
    """``init_state``'s (shape, dtype) stand-ins from the parameters'
    (``model.abstract_params()``): float32 moments and the int32 step,
    nothing allocated."""
    z = tree_map_specs(lambda s: (s[0], torch.float32), abstract_params)
    return {"mu": z, "nu": z, "step": ((), torch.int32)}


def state_axes(param_axes, zero2: bool = False) -> Dict[str, Any]:
    """The state's logical axes: the parameters' for ``mu`` and ``nu``.
    ``zero2`` also shards the float32 moments over the data axis on
    each weight's d_model dim ("embed" -> "opt_data": ZeRO-2, the
    weights stay replicated); the step is a scalar."""
    axes = param_axes
    if zero2:
        axes = tree_map_specs(
            lambda t: tuple("opt_data" if a == "embed" else a for a in t),
            param_axes)
    return {"mu": axes, "nu": axes, "step": ()}


def tree_map_specs(fn, tree):
    """``fn`` over the leaves of a nested dict whose leaves are tuples
    (a (shape, dtype) spec or an axes tuple)."""
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def global_norm(tree, specs=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (None leaves
    count as zeros).  ``specs`` (a tree of partition specs beside
    ``tree``, under a process mesh): a leaf sharded over some mesh axes
    holds a part of its squares, summed over those axes (one all-reduce
    per set of axes), and a replicated leaf counts once, so the norm is
    the whole model's."""
    if specs is None:
        sq = [g.float().square().sum() for g in leaves(tree)
              if g is not None]
        return torch.stack(sq).sum().sqrt()
    groups = {}
    for g, spec in zip(leaves(tree), leaves_of_specs(specs)):
        if g is not None:
            axes = tuple(sorted({a for m in spec if m is not None
                                 for a in (m if isinstance(m, tuple)
                                           else (m,))}))
            groups.setdefault(axes, []).append(g.float().square().sum())
    total = [psum(torch.stack(sq).sum(), axes) for axes, sq in
             sorted(groups.items())]
    return torch.stack(total).sum().sqrt()


def leaves_of_specs(specs):
    """The partition specs of a spec tree (dicts of tuples), in the
    order ``tree.leaves`` gives the tensors of the matching tree."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in leaves_of_specs(specs[k])]
    return [specs]


def _part(t, cut):
    """This rank's part of ``t`` on each (dimension, axes) of ``cut``."""
    for dim, axes in cut:
        n = t.shape[dim] // axis_size(axes)
        t = t.narrow(dim, axis_index(axes) * n, n)
    return t


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state, specs=None,
                  moment_specs=None):
    """One AdamW step, in place: ``p - lr (m^ / (sqrt(n^) + eps) + wd p)``
    with the gradient clipped to ``grad_clip`` by its global norm
    (``specs``: the leaves' partition specs under a process mesh, see
    ``global_norm``).  ``moment_specs`` (ZeRO-2, see ``init_state``):
    a leaf whose moments are a part of it updates that part of itself
    from that part of its (replicated) gradient, and the parameters are
    gathered whole again over those axes, one all-reduce of zero-padded
    buffers a (type, axes).  Returns (params, state, {"grad_norm": device
    scalar, "lr": float})."""
    step = state["step"] + 1
    gnorm = global_norm(grads, specs)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = float(schedule(cfg, step))
    stepf = step.float()
    b1c = float(1 - cfg.b1 ** stepf)
    b2c = float(1 - cfg.b2 ** stepf)
    ps = leaves(params)
    parts = {}
    for p, g, mu, nu, cut in zip(ps, leaves(grads), leaves(state["mu"]),
                                 leaves(state["nu"]),
                                 moment_cuts(specs, moment_specs, len(ps))):
        g = torch.zeros_like(mu) if g is None else _part(g, cut)
        g = g.float() * clip
        mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        nu.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        delta = (mu / b1c) / ((nu / b2c).sqrt_() + cfg.eps)
        pf = _part(p, cut).float()
        if p.ndim >= 2:
            delta.add_(pf, alpha=cfg.weight_decay)
        if not cut:
            p.copy_(pf - lr * delta)
            continue
        buf = torch.zeros_like(p)
        _part(buf, cut).copy_(pf - lr * delta)
        axes = tuple(a for _, ax in cut for a in ax)
        parts.setdefault((p.dtype, axes), []).append((p, buf))
    for (_, axes), pb in parts.items():
        flat = gather_sum(torch.cat([b.reshape(-1) for _, b in pb]), axes)
        i = 0
        for p, _ in pb:
            p.copy_(flat[i:i + p.numel()].view_as(p))
            i += p.numel()
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
