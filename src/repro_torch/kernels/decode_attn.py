"""Flash-decode softmax attention over a KV cache, with GQA.

Replaces the TPU kernel ``src/repro/kernels/decode_attn.py::decode_attn``:
one query per sequence attends over every slot of the cache; q head
``h`` reads kv head ``h // (H / KV)``.  Unlike the reference, which
takes k, v as (B, KV, S, D), ``decode_attn`` takes the cache in the
MODEL layout (B, S, KV, D): the CUDA kernel reads it through strides,
so no transposed copy of the cache is ever made.

On CUDA tensors it launches ``csrc/decode_attn.cu`` (float32 or
bfloat16, float32 softmax and sums, any S); on CPU tensors it runs the
plain twin ``ref.decode_attn_ref``.  Any other device raises.
``launches`` counts kernel launches, and only those.

``lse=True`` also returns each row's log-sum-exp of the scaled scores,
(B, H) float32, from the same launch (the twin: ``torch.logsumexp``):
the parts of a ring held on several devices merge by it.
"""

from __future__ import annotations

import torch

from . import cuda_lib, ref

launches = 0


def decode_attn_plain(q, k, v, lse: bool = False):
    """The plain twin in the model layout: q (B, H, D), k, v
    (B, S, KV, D) -> (B, H, D) in q's type[, lse (B, H) float32]."""
    out = ref.decode_attn_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                              lse=lse)
    if lse:
        out, l = out
        return out, l.to(torch.promote_types(l.dtype, torch.float32))
    return out


def decode_attn(q, k, v, lse: bool = False):
    """q (B, H, D); k, v (B, S, KV, D) -> (B, H, D)[, lse (B, H)]."""
    global launches
    if ref.runs_plain(q):
        return decode_attn_plain(q, k, v, lse)
    out = cuda_lib.decode_attn(q, k, v, lse=lse)
    launches += 1
    return out
