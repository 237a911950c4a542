"""Checkpointing: flat-key npz snapshots of (params, opt state, step)
(port of ``repro.training.checkpoint``, the same files).

``path.npz`` holds one array per leaf under its tree path joined with
``/`` (``params/layers/uvqk``, ``opt/mu/tok``, ``opt/step``) and
``path.json`` the step and each leaf's dtype; bfloat16 leaves are stored
bit for bit as uint16 beside their dtype name.  A checkpoint written by
the reference restores here and the reverse.

Under a process mesh a rank saves the shards it holds (its own file) and
restores them so; ``restore(..., axes=)`` cuts a checkpoint of whole
tensors (one process's, or the reference's) to this rank's shard of
each leaf: its parameters' (FSDP's included) and its moments' (ZeRO-2's
part on "data"), by their logical axes under the current rules.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models.partitioning import shard
from repro_torch.tree import flatten, unflatten

_SEP = "/"


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array as stored, dtype name as the reference writes it)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def save(path, params, opt_state=None, step: int = 0):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tree = {"params": params}
    if opt_state is not None:
        tree["opt"] = opt_state
    arrays, dtypes = {}, {}
    for k, leaf in flatten(tree, _SEP).items():
        arrays[k], dtypes[k] = _to_numpy(leaf)
    np.savez(path.with_suffix(".npz"), **arrays)
    meta = {"step": int(step), "dtypes": dtypes}
    path.with_suffix(".json").write_text(json.dumps(meta))


def restore(path, template, axes=None) -> Tuple[Any, int]:
    """Restore into the structure of ``template`` ({'params': ..,
    'opt': ..}, tensor leaves).  Each leaf comes back as a new tensor of
    the saved dtype on its template leaf's device.  ``axes`` (the
    leaves' logical axes, a tree beside ``template``: {"params":
    ``model.param_axes()``, "opt": ``optimizer.state_axes(...)``}): each
    saved leaf is whole and comes back as this rank's shard under the
    current rules (``partitioning.shard``).  Returns (tree, step)."""
    path = Path(path)
    meta = json.loads(path.with_suffix(".json").read_text())
    cut = flatten(axes, _SEP) if axes is not None else {}
    with np.load(path.with_suffix(".npz")) as data:
        def one(key, tmpl):
            a = data[key]
            if cut.get(key):
                a = np.ascontiguousarray(shard(a, cut[key]))
            device = tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu"
            if meta["dtypes"][key] == "bfloat16":
                return torch.from_numpy(a.view(np.int16)).view(
                    torch.bfloat16).to(device)
            return torch.from_numpy(a).to(device)

        restored = unflatten({k: one(k, t) for k, t in
                              flatten(template, _SEP).items()}, _SEP)
    return restored, meta["step"]
