# Copied from src/repro/configs/zamba2_1p2b.py: only the import is renamed repro -> repro_torch.
"""Zamba2-1.2B: Mamba2 backbone + shared GQA attention block every 6 layers (per-invocation LoRA).
Source: arXiv:2411.15242
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='zamba2-1.2b',
        family='hybrid',
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        attn_every=6,
        rope_theta=10000.0,
        source='arXiv:2411.15242',
        attn_q_chunk=2048,  # perf hillclimb (EXPERIMENTS.md §Perf)
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (2 layers,
    d_model<=512, <=4 experts)."""
    return ModelConfig(
        name='zamba2-smoke',
        family='hybrid',
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=32,
        attn_every=2,
    )
