# Copied from src/repro/configs/qwen3_4b.py: only the import is renamed repro -> repro_torch.
"""Qwen3-4B: dense GQA decoder with qk-norm, explicit head_dim=128.
Source: hf:Qwen/Qwen3-8B
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='qwen3-4b',
        family='dense',
        n_layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab=151936,
        qk_norm=True,
        rope_theta=1000000.0,
        source='hf:Qwen/Qwen3-8B',
        attn_q_chunk=2048,  # perf hillclimb (EXPERIMENTS.md §Perf)
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (2 layers,
    d_model<=512, <=4 experts)."""
    return ModelConfig(
        name='qwen3-smoke',
        family='dense',
        n_layers=2,
        d_model=256,
        n_heads=8,
        n_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab=512,
        qk_norm=True,
        rope_theta=1000000.0,
    )
