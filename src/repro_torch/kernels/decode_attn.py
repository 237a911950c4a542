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
"""

from __future__ import annotations

from . import cuda_lib, ref

launches = 0


def decode_attn_plain(q, k, v):
    """The plain twin in the model layout: q (B, H, D), k, v
    (B, S, KV, D) -> (B, H, D) in q's type."""
    return ref.decode_attn_ref(q, k.transpose(1, 2), v.transpose(1, 2))


def decode_attn(q, k, v):
    """q (B, H, D); k, v (B, S, KV, D) -> (B, H, D)."""
    global launches
    if ref.runs_plain(q):
        return decode_attn_plain(q, k, v)
    out = cuda_lib.decode_attn(q, k, v)
    launches += 1
    return out
