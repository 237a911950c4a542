"""Hand-written Hopper kernels for the relay path, with plain twins.

hstu_attn              — HSTU pointwise (SiLU) causal attention (prefill)
prefix_rank_attn       — ranking-with-cache attention over dense psi
paged_prefix_rank_attn — the same, reading psi from the page pool
segment_rank_attn      — the same over cached spans (beyond-prefix reuse)
decode_attn            — one-query softmax decode over a KV cache (GQA)
ssd_chunk_intra        — Mamba2 SSD intra-chunk contraction
ssd_chunk_state        — Mamba2 SSD per-chunk state summary

The first four launch ``csrc/hstu_rank_attn.cu``, ``decode_attn``
launches ``csrc/decode_attn.cu`` and the SSD stages ``csrc/ssd_chunk.cu``
on CUDA tensors; on CPU tensors each runs its plain-PyTorch twin
(``ref.py``, ``ssd_chunk.py``).  ``ops.py`` adapts the model layout.
Three carry a gradient on the card, each an ``autograd.Function`` whose
forward is the kernel and whose backward is plain torch ops:
``hstu_attn`` (``HSTUAttnFunction``) and the two SSD stages
(``SSDChunkIntraFunction``, ``SSDChunkStateFunction``).
"""
from .ops import (cache_decode_attention, hstu_attention,
                  paged_rank_attention, rank_attention,
                  segment_rank_attention)
