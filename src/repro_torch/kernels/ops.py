"""The kernels in the model layout (B, S, H, D).

Each wrapper swaps axes 1 and 2 as VIEWS (the CUDA kernel reads any
layout with a unit head-dim stride, so nothing is copied) and hands the
tensors to the kernel module, which launches on CUDA and runs the plain
version on the CPU.  Unlike ``repro.kernels.ops`` there is no fallback to
the oracle for shapes a tiling cannot take: the kernel masks its own
ragged edges and takes every shape.
"""

from __future__ import annotations

from .hstu_attn import hstu_attn
from .paged_prefix_attn import paged_prefix_rank_attn
from .prefix_rank_attn import prefix_rank_attn_split


def _bsh_to_bhs(x):
    return x.transpose(1, 2)


def hstu_attention(q, k, v, *, n_total=None):
    """q, k, v: (B, S, H, D). Causal HSTU attention."""
    out = hstu_attn(*map(_bsh_to_bhs, (q, k, v)), n_total=n_total)
    return _bsh_to_bhs(out)


def rank_attention(q, k_new, v_new, k_prefix, v_prefix, *, n_incr,
                   n_total=None):
    """Ranking with a dense cached prefix: q, k_new, v_new (B, Sq, H, D),
    k_prefix, v_prefix (B, P, H, D)."""
    out = prefix_rank_attn_split(
        *map(_bsh_to_bhs, (q, k_prefix, v_prefix, k_new, v_new)),
        n_incr=n_incr, n_total=n_total)
    return _bsh_to_bhs(out)


def paged_rank_attention(q, k_new, v_new, pool, k_table, v_table,
                         prefix_lens, *, n_incr, n_total=None):
    """Ranking with the prefix read from one (N + 1, pt, H, D) pool
    through per-row K and V page tables (B, n_pages)."""
    q, k_new, v_new = map(_bsh_to_bhs, (q, k_new, v_new))
    out = paged_prefix_rank_attn(q, pool, pool, k_table, v_table,
                                 prefix_lens, k_new, v_new, n_incr=n_incr,
                                 n_total=n_total)
    return _bsh_to_bhs(out)
