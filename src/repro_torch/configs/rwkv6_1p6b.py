# Copied from src/repro/configs/rwkv6_1p6b.py: only the import is renamed repro -> repro_torch.
"""RWKV6 (Finch) 1.6B: attention-free, data-dependent decay.
Source: arXiv:2404.05892
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='rwkv6-1.6b',
        family='ssm_rwkv6',
        n_layers=24,
        d_model=2048,
        d_ff=7168,
        vocab=65536,
        glu=False,
        act='relu',
        rope_theta=0.0,
        source='arXiv:2404.05892',
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (2 layers,
    d_model<=512, <=4 experts)."""
    return ModelConfig(
        name='rwkv6-smoke',
        family='ssm_rwkv6',
        n_layers=2,
        d_model=128,
        d_ff=256,
        vocab=512,
        glu=False,
        act='relu',
        rope_theta=0.0,
    )
