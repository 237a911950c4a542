# Copied from src/repro/configs/dbrx_132b.py: only the import is renamed repro -> repro_torch.
"""DBRX-132B: MoE, 16 experts top-4, fine-grained.
Source: hf:databricks/dbrx-base
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='dbrx-132b',
        family='moe',
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab=100352,
        n_experts=16,
        n_shared_experts=0,
        top_k=4,
        d_expert=10752,
        rope_theta=500000.0,
        source='hf:databricks/dbrx-base',
        attn_q_chunk=2048,  # perf hillclimb (EXPERIMENTS.md §Perf)
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (2 layers,
    d_model<=512, <=4 experts)."""
    return ModelConfig(
        name='dbrx-smoke',
        family='moe',
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab=512,
        n_experts=4,
        n_shared_experts=0,
        top_k=2,
        d_expert=128,
    )
