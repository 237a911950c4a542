# Copied from src/repro/configs/internvl2_2b.py: only the import is renamed repro -> repro_torch.
"""InternVL2-2B language backbone (InternLM2-1.8B): vision frontend stubbed as 256 patch embeddings per image.
Source: arXiv:2404.16821
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='internvl2-2b',
        family='vlm',
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=92553,
        n_frontend_tokens=256,
        rope_theta=1000000.0,
        source='arXiv:2404.16821',
        attn_q_chunk=2048,  # perf hillclimb (EXPERIMENTS.md §Perf)
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (2 layers,
    d_model<=512, <=4 experts)."""
    return ModelConfig(
        name='internvl2-smoke',
        family='vlm',
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab=512,
        n_frontend_tokens=8,
    )
