# Copied from src/repro/configs/yi_9b.py: only the import is renamed repro -> repro_torch.
"""Yi-9B: llama-architecture dense GQA decoder.
Source: arXiv:2403.04652
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='yi-9b',
        family='dense',
        n_layers=48,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab=64000,
        rope_theta=10000.0,
        source='arXiv:2403.04652',
        attn_q_chunk=2048,  # perf hillclimb (EXPERIMENTS.md §Perf)
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (2 layers,
    d_model<=512, <=4 experts)."""
    return ModelConfig(
        name='yi-smoke',
        family='dense',
        n_layers=2,
        d_model=256,
        n_heads=8,
        n_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab=512,
    )
