# Copied from src/repro/configs/hstu_gr.py (pure Python): only module paths are renamed repro -> repro_torch.
"""HSTU GR backbone (the paper's own model family): 8 layers, d=256, fp32 KV cache -> 32MB psi at 2K tokens (paper Table 1).
Source: arXiv:2402.17152 (HSTU); RelayGR paper Table 1
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='hstu-gr',
        family='dense',
        hstu=True,
        n_layers=8,
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        head_dim=64,
        d_ff=1024,
        vocab=100000,
        n_tasks=1,
        dtype='float32',
        rope_theta=10000.0,
        source='arXiv:2402.17152',
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (2 layers,
    d_model<=512, <=4 experts)."""
    return ModelConfig(
        name='hstu-smoke',
        family='dense',
        hstu=True,
        n_layers=2,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab=512,
        n_tasks=1,
        dtype='float32',
    )
