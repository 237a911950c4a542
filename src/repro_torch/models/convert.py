"""The weight bridge: ``repro``'s parameter tree -> the port's state.

``jax.random`` and ``torch.Generator`` give different numbers from one
seed, so a test that holds the port against the JAX package initialises
once (in JAX, or from numpy) and loads the same weights into both.  The
tree arrives as numpy arrays — the port never imports JAX:

    {"tok": (Vp, d), "final_norm": (d,), "unembed": (d, Vp),
     "layers": {"ln": (L, d), "uvqk": (L, d, 4, h, hd),
                "ln_attn": (L, h * hd), "wo": (L, h, hd, d)},
     "task_tower": {"w1": (d, 4d), "w2": (4d, n_tasks)}}

Shapes and layouts are identical on both sides, so the bridge is a
rename of nested keys to ``state_dict`` names plus a device copy.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def state_from_tree(tree: Mapping[str, Any], prefix: str = ""
                    ) -> Dict[str, np.ndarray]:
    """Flatten a nested parameter tree to ``state_dict`` keys
    (``layers.uvqk``, ``task_tower.w1``, ...)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(state_from_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def load_jax_params(model: torch.nn.Module, tree: Mapping[str, Any]):
    """Load a ``repro`` HSTU parameter tree (numpy leaves) into ``model``
    in place; every key must match in name and shape."""
    state = state_from_tree(tree)
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
            dst.copy_(torch.tensor(arr, dtype=dst.dtype))
    return model
