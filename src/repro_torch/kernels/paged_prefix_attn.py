"""Paged ranking-with-cache HSTU attention — rank straight from the pool.

Replaces two TPU kernels of ``src/repro/kernels/paged_prefix_attn.py``:

* ``paged_prefix_rank_attn`` (``_prefix_pages_kernel`` +
  ``_new_tokens_kernel``).  The cached prefix lives in a page pool
  ``(N + 1, page_tokens, H, D)`` whose last row is the all-zero null
  page; each row's prefix is named by a page table, and a per-row
  ``prefix_lens`` masks keys that are not resident.
* ``segment_rank_attn`` (``_segment_pages_kernel`` +
  ``_new_tokens_kernel``): beyond-prefix reuse.  The table names the
  pages of a row's cached SPANS in order; per-page ``page_pos`` (global
  position of the page's first token) and ``page_valid`` (tokens the
  page holds) place every cached key, and a fresh token at ``q_pos``
  sees a cached key only at or before its own position.

Unlike the reference kernel, K and V take SEPARATE page tables: the live
window stores a layer's K and V as distinct pages of one pool, addressed
by a ``(B, L, 2, n_pages)`` launch table (``core/executors.py``); equal
tables give the reference interface.  On Hopper the kernel is one pass —
the block walks its pages, then the new-token tiles, in one f32
accumulator — so no partial sum reaches device memory.  Its pages come
in by TMA: each block stages its page-table entries once, and one TMA
box per page and column block is issued from the pool's tensor map, so
the pool must meet TMA's rules (``cuda_lib.tma_pool_geometry``; a pool
that breaks one raises a ValueError naming it), and ``page_tokens``
divides the 64-key tile.

On CUDA tensors it launches ``csrc/hstu_rank_attn.cu``; on CPU tensors it
runs the plain version (gather through the tables, then the dense
oracle).  Any other device raises.  q, the new K/V and the pools are
float32 or bfloat16 alike; the output has q's type.  ``launches`` (paged prefix) and
``launches_segment`` count kernel launches, and only those.
"""

from __future__ import annotations

import numpy as np

from . import cuda_lib, ref

launches = 0
launches_segment = 0


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
    if ref.runs_plain(q):
        return paged_prefix_rank_attn_plain(
            q, k_pages, v_pages, k_table, v_table, prefix_lens, k_new,
            v_new, n_incr=n_incr, n_total=n_total)
    out = cuda_lib.rank_attn(
        q, k_new, v_new, n_incr=n_incr, n_total=n_total,
        pages=(k_pages, v_pages, k_table, v_table, prefix_lens))
    launches += 1
    return out


def segment_rank_attn_plain(q, k_pages, v_pages, k_table, v_table,
                            page_pos, page_valid, q_pos, k_new, v_new, *,
                            n_items: int, n_total: float = None):
    """The plain-PyTorch version (``ref.paged_segment_rank_attn_ref``)."""
    return ref.paged_segment_rank_attn_ref(
        q, k_pages, v_pages, k_table, v_table, page_pos, page_valid, q_pos,
        k_new, v_new, n_items=n_items, n_total=n_total)


def segment_rank_attn(q, k_pages, v_pages, k_table, v_table, page_pos,
                      page_valid, q_pos, k_new, v_new, *, n_items: int,
                      n_total: float = None):
    """Rank with psi read from an ordered list of cached spans.

    q, k_new, v_new:  (B, H, Sq, D) fresh tokens, the last ``n_items``
                      of them candidate items
    k_pages, v_pages: (N + 1, page_tokens, H, D) pools (may be one tensor)
    k_table, v_table: (B, n_pages) int32 span pages in span order
                      (null-page padded)
    page_pos:         (B, n_pages) int32 global position of each page's
                      first token (0 on padded slots)
    page_valid:       (B, n_pages) int32 tokens each page holds (0 on
                      padded slots)
    q_pos:            (B, Sq) int32 global positions of the fresh
                      tokens, strictly increasing per row

    ``n_total`` defaults to ``n_pages * page_tokens + Sq``, as in the
    reference.  With one span at [0, prefix_len) and ``q_pos`` after it
    the call equals ``paged_prefix_rank_attn`` bit for bit."""
    global launches_segment
    n_total = n_total or k_table.shape[1] * k_pages.shape[1] + q.shape[2]
    if ref.runs_plain(q):
        return segment_rank_attn_plain(
            q, k_pages, v_pages, k_table, v_table, page_pos, page_valid,
            q_pos, k_new, v_new, n_items=n_items, n_total=n_total)
    out = cuda_lib.rank_attn(
        q, k_new, v_new, n_incr=q.shape[2] - n_items, n_total=n_total,
        pages=(k_pages, v_pages, k_table, v_table, None),
        spans=(page_pos, page_valid, q_pos))
    launches_segment += 1
    return out


def pack_segments(k_cached, v_cached, spans, page_tokens: int,
                  n_pages: int = None):
    """Test/reference helper, carried over from ``repro``: slice per-row
    cached tokens — (B, H, C, D) numpy, row ``b``'s cached tokens packed
    contiguously in span order — into span-aware pool buffers.
    ``spans[b]`` is an ordered list of (global_start, length) pairs;
    every span pads to whole pages.  Returns (k_pages, v_pages, table,
    page_pos, page_valid) with the all-zero null page as the last pool
    row."""
    k_cached, v_cached = np.asarray(k_cached), np.asarray(v_cached)
    B, H, C, D = k_cached.shape
    per_row = [sum(-(-int(ln) // page_tokens) for _, ln in row)
               for row in spans]
    n_pages = n_pages or max(per_row)
    total = sum(per_row)
    kp = np.zeros((total + 1, page_tokens, H, D), k_cached.dtype)
    vp = np.zeros_like(kp)
    table = np.full((B, n_pages), total, np.int32)     # pad = null page
    page_pos = np.zeros((B, n_pages), np.int32)
    page_valid = np.zeros((B, n_pages), np.int32)
    pid = 0
    for b, row in enumerate(spans):
        off = 0           # consumed cached tokens within this row
        slot = 0
        for start, ln in row:
            for j in range(-(-int(ln) // page_tokens)):
                lo, hi = j * page_tokens, min((j + 1) * page_tokens,
                                              int(ln))
                kp[pid, :hi - lo] = np.moveaxis(
                    k_cached[b, :, off + lo:off + hi], 0, 1)
                vp[pid, :hi - lo] = np.moveaxis(
                    v_cached[b, :, off + lo:off + hi], 0, 1)
                table[b, slot] = pid
                page_pos[b, slot] = int(start) + lo
                page_valid[b, slot] = hi - lo
                pid += 1
                slot += 1
            off += int(ln)
    return kp, vp, table, page_pos, page_valid


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
