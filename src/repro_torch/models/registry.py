"""Model registry: family name -> model class; config id -> ModelConfig
(port of ``repro.models.registry``: every family and every id of the
reference)."""

from __future__ import annotations

import importlib

from .arch import HybridModel, SSMModel, TransformerModel
from .config import ModelConfig
from .encdec import EncDecModel
from .hstu import HSTUModel

_FAMILY = {
    "dense": TransformerModel,
    "moe": TransformerModel,
    "vlm": TransformerModel,
    "ssm_mamba2": SSMModel,
    "ssm_rwkv6": SSMModel,
    "hybrid": HybridModel,
    "encdec": EncDecModel,
    "hstu": HSTUModel,
}

ARCH_IDS = [
    "starcoder2_15b", "zamba2_1p2b", "qwen3_4b", "starcoder2_7b",
    "rwkv6_1p6b", "seamless_m4t_large_v2", "yi_9b", "internvl2_2b",
    "deepseek_moe_16b", "dbrx_132b", "hstu_gr",
]

# CLI aliases matching the assignment spelling
ALIASES = {
    "starcoder2-15b": "starcoder2_15b",
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen3-4b": "qwen3_4b",
    "starcoder2-7b": "starcoder2_7b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "yi-9b": "yi_9b",
    "internvl2-2b": "internvl2_2b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "dbrx-132b": "dbrx_132b",
    "hstu-gr": "hstu_gr",
}


def build_model(cfg: ModelConfig, device="cuda"):
    family = "hstu" if cfg.hstu else cfg.family
    return _FAMILY[family](cfg, device=device)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    arch_id = ALIASES.get(arch_id, arch_id).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.smoke_config() if smoke else mod.config()


def get_model(arch_id: str, smoke: bool = False, device="cuda"):
    """The model of ``arch_id`` on ``device``, its parameters allocated
    but not drawn: call ``init(generator)`` or load a tree."""
    return build_model(get_config(arch_id, smoke=smoke), device=device)
