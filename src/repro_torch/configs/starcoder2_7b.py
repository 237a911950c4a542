# Copied from src/repro/configs/starcoder2_7b.py: only the import is renamed repro -> repro_torch.
"""StarCoder2-7B: dense GQA decoder, RoPE, sliding-window 4096. 36 heads do not divide the 16-way model axis; attention degrades to replicated TP (see DESIGN.md).
Source: arXiv:2402.19173
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='starcoder2-7b',
        family='dense',
        n_layers=32,
        d_model=4608,
        n_heads=36,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab=49152,
        glu=False,
        act='gelu',
        rope_theta=100000.0,
        sliding_window=4096,
        source='arXiv:2402.19173',
        attn_q_chunk=2048,  # perf hillclimb (EXPERIMENTS.md §Perf)
        head_pad=48,  # perf hillclimb (EXPERIMENTS.md §Perf)
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (2 layers,
    d_model<=512, <=4 experts)."""
    return ModelConfig(
        name='starcoder2-7b-smoke',
        family='dense',
        n_layers=2,
        d_model=288,
        n_heads=9,
        n_kv_heads=3,
        head_dim=32,
        d_ff=576,
        vocab=512,
        glu=False,
        act='gelu',
        rope_theta=100000.0,
        sliding_window=64,
    )
