# Copied from src/repro/configs/seamless_m4t_large_v2.py: only the import is renamed repro -> repro_torch.
"""SeamlessM4T-large-v2 transformer backbone: enc-dec, audio frontend stubbed (frame embeddings provided by input_specs).
Source: arXiv:2308.11596
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='seamless-m4t-large-v2',
        family='encdec',
        n_layers=24,
        n_enc_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab=256206,
        n_frontend_tokens=1536,
        rope_theta=10000.0,
        source='arXiv:2308.11596',
        attn_q_chunk=2048,  # perf hillclimb (EXPERIMENTS.md §Perf)
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (2 layers,
    d_model<=512, <=4 experts)."""
    return ModelConfig(
        name='seamless-smoke',
        family='encdec',
        n_layers=2,
        n_enc_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        n_frontend_tokens=8,
    )
