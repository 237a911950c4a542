"""Ranking-with-cache HSTU attention — the RelayGR consumption path.

Replaces the TPU kernel
``src/repro/kernels/prefix_rank_attn.py::prefix_rank_attn``.  Queries are
the incremental tokens followed by the candidate items; keys are the
cached prefix psi followed by the new tokens.  Incremental tokens attend
causally over prefix + earlier incr; items attend to prefix + incr +
themselves only.

On CUDA tensors ``prefix_rank_attn_split`` launches
``csrc/hstu_rank_attn.cu``, which reads the prefix and the new tokens
from two separate views, so no [prefix | new] concatenation is ever
materialized; on CPU tensors it runs the plain version.  Any other
device raises.  q and every K/V are float32 or bfloat16 alike; the
output has q's type.  ``launches`` counts kernel launches, and only
those.
"""

from __future__ import annotations

import torch

from . import cuda_lib, ref

launches = 0


def prefix_rank_attn_plain(q, k, v, *, n_prefix: int, n_incr: int,
                           n_total: float = None):
    """The plain-PyTorch version, reference signature:
    q (B, H, Sq, D); k, v (B, H, n_prefix + Sq, D)."""
    return ref.prefix_rank_attn_ref(q, k, v, n_prefix=n_prefix,
                                    n_incr=n_incr, n_total=n_total)


def prefix_rank_attn_split(q, k_prefix, v_prefix, k_new, v_new, *,
                           n_incr: int, n_total: float = None):
    """q, k_new, v_new: (B, H, Sq, D); k_prefix, v_prefix: (B, H, P, D).
    ``n_total`` defaults to P + Sq."""
    global launches
    P, Sq = k_prefix.shape[2], q.shape[2]
    n_total = n_total or P + Sq
    if ref.runs_plain(q):
        return prefix_rank_attn_plain(
            q, torch.cat([k_prefix, k_new], dim=2),
            torch.cat([v_prefix, v_new], dim=2),
            n_prefix=P, n_incr=n_incr, n_total=n_total)
    out = cuda_lib.rank_attn(q, k_new, v_new, n_incr=n_incr, n_total=n_total,
                             prefix=(k_prefix, v_prefix))
    launches += 1
    return out


def prefix_rank_attn(q, k, v, *, n_prefix: int, n_incr: int,
                     n_total: float = None):
    """Reference signature: q (B, H, Sq, D); k, v (B, H, Sk, D) with
    Sk = n_prefix + Sq.  The split happens on views."""
    Sq = q.shape[2]
    if k.shape[2] != n_prefix + Sq:
        raise ValueError(f"Sk={k.shape[2]} != n_prefix + Sq = "
                         f"{n_prefix} + {Sq}")
    return prefix_rank_attn_split(
        q, k[:, :, :n_prefix], v[:, :, :n_prefix], k[:, :, n_prefix:],
        v[:, :, n_prefix:], n_incr=n_incr, n_total=n_total)
