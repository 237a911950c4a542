"""Core layers of the HSTU path, in PyTorch (port of ``repro.models.layers``).

Only what the relay path needs so far: ``ParamSpec`` (the fan-in normal
init rule), ``rms_norm`` and interleaved-pair RoPE.  Tensors keep the
reference's layouts: (..., S, H, D) for heads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | value
    scale: float = 1.0          # stddev multiplier for "normal"
    value: float = 0.0          # for init == "value"
    dtype: str = "float32"

    def initialise(self, generator: torch.Generator) -> torch.Tensor:
        """Draw on the CPU from ``generator`` (device-independent
        numbers), with the reference's rule: ``scale / sqrt(fan_in)``
        with fan_in the second-to-last dim.  ``jax.random`` gives other
        numbers from the same seed, so cross-framework tests load one
        set of weights into both (``models/convert.py``)."""
        dt = DTYPES[self.dtype]
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt)
        if self.init == "value":
            return torch.full(self.shape, self.value, dtype=dt)
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        std = self.scale / math.sqrt(max(fan_in, 1))
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32)
        return (x * std).to(dt)


def rms_norm(x, weight, eps: float = 1e-6):
    """RMS norm computed in float32 whatever the input type."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * weight.float()
    return out.to(dt)


def rope_frequencies(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions, head_dim: int, theta: float):
    """cos and sin of the rotation angles, (..., S, D/2) for positions
    (..., S): computed once per forward and shared by every layer."""
    freqs = rope_frequencies(head_dim, theta, device=positions.device)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def rotate_pairs(x, cos, sin):
    """Rotate interleaved pairs (x[2i], x[2i+1]) by angles whose cos/sin
    broadcast against x[..., ::2] — the reference's convention, not
    rotate-half."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    cos, sin = rope_tables(positions, x.shape[-1], theta)
    return rotate_pairs(x, cos[..., None, :], sin[..., None, :])
