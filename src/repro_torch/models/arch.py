"""Shared architecture pieces, in PyTorch (port of ``repro.models.arch``).

Only the embedding / unembedding and the layer stacking the HSTU model
uses; the Transformer, SSM and hybrid families are still to port
(ROADMAP Queue 1, item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from .config import ModelConfig
from .layers import ParamSpec, rms_norm


def stack_specs(specs: Dict[str, ParamSpec], n: int) -> Dict[str, ParamSpec]:
    """Add a leading stacked-layer dim to every ParamSpec."""
    return {k: dataclasses.replace(s, shape=(n,) + s.shape,
                                   axes=("layers",) + s.axes)
            for k, s in specs.items()}


def embed_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, vp, dt = cfg.d_model, cfg.vocab_padded, cfg.dtype
    return {
        "tok": ParamSpec((vp, d), ("vocab", "embed"), scale=1.0, dtype=dt),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "unembed": ParamSpec((d, vp), ("embed", "vocab"), dtype=dt),
    }


def _embed(tok, tokens):
    return tok[tokens]


def _logits(final_norm, unembed, x):
    return rms_norm(x, final_norm) @ unembed
