"""Model registry: family name -> model class; config id -> ModelConfig.

The port carries only the ``hstu`` family so far; every other family of
``repro.models.registry`` is still to port (ROADMAP Queue 1, item 9).
"""

from __future__ import annotations

import importlib

from .config import ModelConfig
from .hstu import HSTUModel

_FAMILY = {
    "hstu": HSTUModel,
}

ARCH_IDS = ["hstu_gr"]

ALIASES = {
    "hstu-gr": "hstu_gr",
}


def build_model(cfg: ModelConfig, device="cuda"):
    family = "hstu" if cfg.hstu else cfg.family
    if family not in _FAMILY:
        raise NotImplementedError(
            f"model family {family!r} ({cfg.name}) is not ported to "
            f"repro_torch yet (ROADMAP Queue 1, item 9)")
    return _FAMILY[family](cfg, device=device)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    arch_id = ALIASES.get(arch_id, arch_id).replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not ported to repro_torch yet "
            f"(ROADMAP Queue 1, item 9)")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.smoke_config() if smoke else mod.config()
