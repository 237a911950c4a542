"""Paged ranking-with-cache HSTU attention — rank straight from the pool.

Replaces the TPU kernel
``src/repro/kernels/paged_prefix_attn.py::paged_prefix_rank_attn``
(``_prefix_pages_kernel`` + ``_new_tokens_kernel``).  The cached prefix
lives in a page pool ``(N + 1, page_tokens, H, D)`` whose last row is the
all-zero null page; each row's prefix is named by a page table, and a
per-row ``prefix_lens`` masks keys that are not resident.

Unlike the reference kernel, K and V take SEPARATE page tables: the live
window stores a layer's K and V as distinct pages of one pool, addressed
by a ``(B, L, 2, n_pages)`` launch table (``core/executors.py``); equal
tables give the reference interface.  On Hopper the kernel is one pass —
the block walks its pages, then the new-token tiles, in one f32
accumulator — so no partial sum reaches device memory.

On CUDA tensors it launches ``csrc/hstu_rank_attn.cu``; on CPU tensors it
runs the plain version (gather through the tables, then the dense
oracle).  Any other device raises.  ``launches`` counts kernel launches,
and only those.
"""

from __future__ import annotations

import numpy as np

from . import cuda_lib, ref

launches = 0


def paged_prefix_rank_attn_plain(q, k_pages, v_pages, k_table, v_table,
                                 prefix_lens, k_new, v_new, *, n_incr: int,
                                 n_total: float = None):
    """The plain-PyTorch version (``ref.paged_prefix_rank_attn_ref``)."""
    return ref.paged_prefix_rank_attn_ref(
        q, k_pages, v_pages, k_table, v_table, prefix_lens, k_new, v_new,
        n_incr=n_incr, n_total=n_total)


def paged_prefix_rank_attn(q, k_pages, v_pages, k_table, v_table,
                           prefix_lens, k_new, v_new, *, n_incr: int,
                           n_total: float = None):
    """Rank with psi read from the page pool.

    q, k_new, v_new:  (B, H, Sq, D) incr + item tokens
    k_pages, v_pages: (N + 1, page_tokens, H, D) pools (may be one tensor)
    k_table, v_table: (B, n_pages) int32 page ids (null-page padded)
    prefix_lens:      (B,) int32 resident prefix tokens per row

    ``n_total`` defaults to ``n_pages * page_tokens + Sq``, the padded
    context the dense bucketed caller normalizes by."""
    global launches
    n_total = n_total or k_table.shape[1] * k_pages.shape[1] + q.shape[2]
    if q.device.type == "cpu":
        return paged_prefix_rank_attn_plain(
            q, k_pages, v_pages, k_table, v_table, prefix_lens, k_new,
            v_new, n_incr=n_incr, n_total=n_total)
    out = cuda_lib.rank_attn(
        q, k_new, v_new, n_incr=n_incr, n_total=n_total,
        pages=(k_pages, v_pages, k_table, v_table, prefix_lens))
    launches += 1
    return out


def pack_pages(k_dense, v_dense, prefix_lens, page_tokens: int,
               n_pages: int = None):
    """Test/reference helper, carried over from ``repro``: slice dense
    per-row prefixes — (B, H, P, D) numpy — into pool buffers + page
    tables.  Returns (k_pages, v_pages, table (B, np), prefix_lens i32);
    the last pool row is the all-zero null page."""
    k_dense, v_dense = np.asarray(k_dense), np.asarray(v_dense)
    B, H, P, D = k_dense.shape
    plens = np.asarray(prefix_lens, np.int32)
    per_row = [-(-int(p) // page_tokens) for p in plens]
    n_pages = n_pages or max(per_row)
    total = sum(per_row)
    kp = np.zeros((total + 1, page_tokens, H, D), k_dense.dtype)
    vp = np.zeros_like(kp)
    table = np.full((B, n_pages), total, np.int32)     # pad = null page
    pid = 0
    for b in range(B):
        for j in range(per_row[b]):
            lo, hi = j * page_tokens, min((j + 1) * page_tokens, int(plens[b]))
            kp[pid, :hi - lo] = np.moveaxis(k_dense[b, :, lo:hi], 0, 1)
            vp[pid, :hi - lo] = np.moveaxis(v_dense[b, :, lo:hi], 0, 1)
            table[b, j] = pid
            pid += 1
    return kp, vp, table, plens
