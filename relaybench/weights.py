"""The weights of a run: drawn from the seed on the device, in a few
large calls, loaded into the port's model and handed to the reference.

Rule: every matrix N(0, 1 / fan_in) with fan_in its true input width,
the embedding N(0, 1), the RMS-norm gains 1 + N(0, 0.1^2).  Matrices are
drawn in float32 and stored in the served type; the reference gets the
stored values widened to float32, so both sides compute with the same
numbers.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

# name -> (shape from the sizes, std from the sizes; None: a gain)
def shapes(c: dict) -> Dict[str, tuple]:
    L, d, h, hd = c["n_layers"], c["d_model"], c["n_heads"], c["head_dim"]
    vp = (c["vocab"] + 255) // 256 * 256
    return {
        "tok": ((vp, d), 1.0),
        "unembed": ((d, vp), 1 / math.sqrt(d)),
        "final_norm": ((d,), None),
        "layers.ln": ((L, d), None),
        "layers.uvqk": ((L, d, 4, h, hd), 1 / math.sqrt(d)),
        "layers.ln_attn": ((L, h * hd), None),
        "layers.wo": ((L, h, hd, d), 1 / math.sqrt(h * hd)),
        "task_tower.w1": ((d, 4 * d), 1 / math.sqrt(d)),
        "task_tower.w2": ((4 * d, c["n_tasks"]), 1 / math.sqrt(4 * d)),
    }


GAINS = ("final_norm", "layers.ln", "layers.ln_attn")


def make(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 tensors on ``device``, each already rounded to the type
    the program stores it in (gains stay float32)."""
    from .traffic import seed_rng
    g = torch.Generator(device=device)
    g.manual_seed(int(seed_rng(seed, 4).integers(0, 2 ** 63)))
    served = {"float32": torch.float32,
              "bfloat16": torch.bfloat16}[c["dtype"]]
    out = {}
    for name, (shape, std) in shapes(c).items():
        x = torch.randn(shape, generator=g, device=device)
        if std is None:
            out[name] = 1.0 + 0.1 * x
        else:
            out[name] = (x * std).to(served).float()
    return out


def load(model, w: Dict[str, torch.Tensor]) -> None:
    """Copy the weights into the port's parameters (each in its own
    type; a bf16 parameter takes the already-rounded values exactly)."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, t in w.items():
            p = params[name]
            if tuple(p.shape) != tuple(t.shape):
                raise ValueError(f"{name}: port {tuple(p.shape)}, "
                                 f"benchmark {tuple(t.shape)}")
            p.copy_(t.to(p.dtype))
