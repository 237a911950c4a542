"""Model registry: family name -> model class; config id -> ModelConfig.

The port carries the ``dense``, ``moe``, ``vlm``, ``hybrid`` and ``hstu``
families; ``ssm_rwkv6`` / ``ssm_mamba2`` (``SSMModel``) and ``encdec`` are
still to port (ROADMAP Queue 1, item 9) and raise ``NotImplementedError``,
as do their config ids.
"""

from __future__ import annotations

import importlib

from .arch import HybridModel, TransformerModel
from .config import ModelConfig
from .hstu import HSTUModel

_FAMILY = {
    "dense": TransformerModel,
    "moe": TransformerModel,
    "vlm": TransformerModel,
    "hybrid": HybridModel,
    "hstu": HSTUModel,
}

# the reference's ids, in its order, less rwkv6_1p6b and
# seamless_m4t_large_v2 (not ported yet)
ARCH_IDS = [
    "starcoder2_15b", "zamba2_1p2b", "qwen3_4b", "starcoder2_7b", "yi_9b",
    "internvl2_2b", "deepseek_moe_16b", "dbrx_132b", "hstu_gr",
]

ALIASES = {
    "starcoder2-15b": "starcoder2_15b",
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen3-4b": "qwen3_4b",
    "starcoder2-7b": "starcoder2_7b",
    "yi-9b": "yi_9b",
    "internvl2-2b": "internvl2_2b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "dbrx-132b": "dbrx_132b",
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
