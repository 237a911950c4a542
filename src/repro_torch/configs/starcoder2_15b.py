# Copied from src/repro/configs/starcoder2_15b.py: only the import is renamed repro -> repro_torch.
"""StarCoder2-15B: dense GQA decoder, RoPE, sliding-window 4096.
Source: arXiv:2402.19173
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='starcoder2-15b',
        family='dense',
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        head_dim=128,
        d_ff=24576,
        vocab=49152,
        glu=False,
        act='gelu',
        rope_theta=100000.0,
        sliding_window=4096,
        source='arXiv:2402.19173',
        attn_q_chunk=2048,  # perf hillclimb (EXPERIMENTS.md §Perf)
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (2 layers,
    d_model<=512, <=4 experts)."""
    return ModelConfig(
        name='starcoder2-smoke',
        family='dense',
        n_layers=2,
        d_model=256,
        n_heads=8,
        n_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab=512,
        glu=False,
        act='gelu',
        rope_theta=100000.0,
        sliding_window=64,
    )
