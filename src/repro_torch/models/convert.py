"""The weight bridge: ``repro``'s parameter tree <-> the port's state,
and a reference optimizer state -> the port's.

``jax.random`` and ``torch.Generator`` give different numbers from one
seed, so a test that holds the port against the JAX package initialises
once (in JAX, or from numpy) and loads the same weights into both.  The
tree arrives as numpy arrays — the port never imports JAX:

    {"tok": (Vp, d), "final_norm": (d,), "unembed": (d, Vp),
     "layers": {"ln": (L, d), "uvqk": (L, d, 4, h, hd),
                "ln_attn": (L, h * hd), "wo": (L, h, hd, d)},
     "task_tower": {"w1": (d, 4d), "w2": (4d, n_tasks)}}

The hybrid's tree nests deeper (``sections`` stacked twice, as
``(n_sections, attn_every, ...)``; ``shared_attn.attn.wq``), and a
Transformer's holds ``layers.attn`` / ``layers.ffn`` or ``layers.moe``
(its ``router`` float32 in a model of any type) and a VLM's
``projector``, an SSM stack's ``layers.mixer`` (RWKV6's ``mu``, ``w0``,
``u`` float32 in a model of any type; or Mamba2's), and an enc-dec's
``encoder.attn``, ``decoder.attn`` / ``decoder.xattn`` / ``decoder.lnx``
and ``enc_norm``; their module names mirror the keys, so the same
flattening maps each one to one.  Each leaf is copied into the
parameter's own type.

Shapes and layouts are identical on both sides, so the bridge is a
rename of nested keys to ``state_dict`` names plus a device copy, and
back (``param_tree`` / ``export_params``).
Leaves of a 16-bit float type (JAX's bfloat16 arrives as an
``ml_dtypes`` numpy type that torch cannot read) go through float32,
which holds every bfloat16 and float16 value exactly.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.models.partitioning import current_rules, shard
from repro_torch.tree import flatten, unflatten


def state_from_tree(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flatten a nested parameter tree to ``state_dict`` keys
    (``layers.uvqk``, ``task_tower.w1``, ...)."""
    return {k: np.asarray(v) for k, v in flatten(tree, ".").items()}


def shard_state(full: Mapping[str, Any], axes: Mapping[str, Any],
                rules=None) -> Dict[str, Any]:
    """Each full weight of ``full`` ({state_dict name: tensor or numpy})
    cut to this rank's shard by ``Rules.spec`` of its logical axes
    (``axes``, by the same names: ``flatten(model.param_axes())``) at
    the rank's coordinates (``partitioning.shard``); the weights
    themselves outside a process mesh."""
    return {k: shard(v, axes[k], rules) for k, v in full.items()}


def load_jax_params(model: torch.nn.Module, tree: Mapping[str, Any]):
    """Load a ``repro`` parameter tree (numpy leaves) into ``model`` in
    place; every key must match in name and shape.  A model built under
    a process mesh takes its rank's shard of each full weight
    (``shard_state``)."""
    state = state_from_tree(tree)
    if current_rules() is not None:
        state = shard_state(state, flatten(model.param_axes(), "."))
    own = model.state_dict()
    if set(state) != set(own):
        raise KeyError(f"parameter names differ: missing "
                       f"{sorted(set(own) - set(state))}, unexpected "
                       f"{sorted(set(state) - set(own))}")
    with torch.no_grad():
        for name, arr in state.items():
            dst = own[name]
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {arr.shape} != "
                                 f"{tuple(dst.shape)}")
            if arr.dtype.itemsize == 2 and arr.dtype.kind in "fV":
                arr = arr.astype(np.float32)     # float16 / bfloat16
            dst.copy_(torch.tensor(arr, dtype=dst.dtype))
    return model


def param_tree(model: torch.nn.Module) -> Dict[str, Any]:
    """The model's parameters as the reference's nested tree, the live
    tensors themselves (what the optimizer updates in place)."""
    return unflatten(dict(model.named_parameters()), ".")


def export_params(model: torch.nn.Module) -> Dict[str, Any]:
    """The reverse of ``load_jax_params``: the parameters as a nested
    tree of numpy arrays in the reference's layout.  16-bit float leaves
    come out as float32 (exact; numpy has no bfloat16)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype.itemsize == 2 else t).numpy()
    return unflatten({k: host(v) for k, v in model.named_parameters()}, ".")


def load_jax_opt_state(model: torch.nn.Module, state: Mapping[str, Any],
                       zero2: bool = False):
    """A reference optimizer state ``{"mu": tree, "nu": tree, "step"}``
    (numpy leaves) as the port's, keyed like ``param_tree(model)``:
    float32 moments on the model's device, ``step`` an int32 host
    scalar.  Names and shapes must match the model's parameters.  A
    model built under a process mesh takes this rank's shard of each
    full moment, cut by the moments' logical axes
    (``optimizer.state_axes(model.param_axes(), zero2)``) under the
    current rules: its parameter's shard (FSDP's included), or under
    ``zero2`` this rank's part of it on "data"."""
    from repro_torch.training.optimizer import state_axes
    own = dict(model.named_parameters())
    shapes = {k: tuple(sd[0]) for k, sd in
              flatten(model.abstract_params(), ".").items()}
    axes = (flatten(state_axes(model.param_axes(), zero2)["mu"], ".")
            if current_rules() is not None else None)

    def moments(tree):
        flat = state_from_tree(tree)
        if set(flat) != set(own):
            raise KeyError(f"moment names differ from the parameters: "
                           f"missing {sorted(set(own) - set(flat))}, "
                           f"unexpected {sorted(set(flat) - set(own))}")
        for name, arr in flat.items():
            if tuple(arr.shape) != shapes[name]:
                raise ValueError(f"{name}: shape {arr.shape} != "
                                 f"{shapes[name]}")
        if axes is not None:
            flat = shard_state(flat, axes)
        out = {name: torch.tensor(np.ascontiguousarray(arr),
                                  dtype=torch.float32, device=own[name].device)
               for name, arr in flat.items()}
        return unflatten(out, ".")

    return {"mu": moments(state["mu"]), "nu": moments(state["nu"]),
            "step": torch.tensor(np.asarray(state["step"]),
                                 dtype=torch.int32)}
