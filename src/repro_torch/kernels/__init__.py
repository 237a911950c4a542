"""Hand-written Hopper kernels for the relay path, with plain twins.

hstu_attn              — HSTU pointwise (SiLU) causal attention (prefill)
prefix_rank_attn       — ranking-with-cache attention over dense psi
paged_prefix_rank_attn — the same, reading psi from the page pool

All three launch the one CUDA source ``csrc/hstu_rank_attn.cu`` on CUDA
tensors and run their plain-PyTorch version (``ref.py``) on CPU tensors.
``ops.py`` adapts the model layout (B, S, H, D).
"""
from .ops import hstu_attention, paged_rank_attention, rank_attention
