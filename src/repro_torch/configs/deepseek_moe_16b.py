# Copied from src/repro/configs/deepseek_moe_16b.py: only the import is renamed repro -> repro_torch.
"""DeepSeekMoE-16B: fine-grained MoE, 64 routed experts top-6 + 2 shared experts.
Source: arXiv:2401.06066
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='deepseek-moe-16b',
        family='moe',
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab=102400,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        d_expert=1408,
        rope_theta=10000.0,
        source='arXiv:2401.06066',
        attn_q_chunk=2048,  # perf hillclimb (EXPERIMENTS.md §Perf)
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (2 layers,
    d_model<=512, <=4 experts)."""
    return ModelConfig(
        name='deepseek-moe-smoke',
        family='moe',
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=64,
        vocab=512,
        n_experts=4,
        n_shared_experts=1,
        top_k=2,
        d_expert=64,
    )
