"""Plain-PyTorch twins of ``repro.kernels.ref`` (the correctness contract).

Shapes use the kernel layout (B, H, S, D); ``ops.py`` adapts from the
model layout (B, S, H, D).  These are what every kernel wrapper runs on
CPU tensors and what ``chip_smoke.py`` holds each CUDA kernel against.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _silu_scores(q, k, n_total: float):
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    return F.silu(logits) / n_total


def hstu_attn_ref(q, k, v, *, n_total: float = None):
    """HSTU pointwise attention, causal.  q, k, v: (B, H, S, D)."""
    S = q.shape[2]
    a = _silu_scores(q, k, n_total or S)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    a = torch.where(mask, a, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", a.to(v.dtype), v)


def rank_mask_ref(n_prefix: int, n_incr: int, n_items: int, device=None):
    """(Sq, Sk) ranking mask: incr causal; items see prefix+incr+self."""
    Sq = n_incr + n_items
    Sk = n_prefix + n_incr + n_items
    qi = torch.arange(Sq, device=device)[:, None]
    ki = torch.arange(Sk, device=device)[None, :]
    causal = ki <= qi + n_prefix
    is_item_q = qi >= n_incr
    is_item_k = ki >= n_prefix + n_incr
    self_key = ki == qi + n_prefix
    items_ok = torch.where(is_item_q, ~is_item_k | self_key, True)
    return causal & items_ok


def prefix_rank_attn_ref(q, k, v, *, n_prefix: int, n_incr: int,
                         n_total: float = None):
    """Ranking-with-cache HSTU attention.

    q: (B, H, Sq, D) new tokens (incr + items);
    k, v: (B, H, Sk, D) with Sk = n_prefix + Sq (cached prefix concat new).
    """
    Sq = q.shape[2]
    a = _silu_scores(q, k, n_total or k.shape[2])
    mask = rank_mask_ref(n_prefix, n_incr, Sq - n_incr, device=q.device)
    a = torch.where(mask, a, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", a.to(v.dtype), v)


def gather_pages(pages, table, prefix_lens):
    """Dense (B, H, n_pages * page_tokens, D) prefix gathered from a
    (N + 1, page_tokens, H, D) pool through a (B, n_pages) page table,
    with every key at or past the row's ``prefix_lens`` zeroed — a zero
    key and value contribute silu(0) * 0 = 0, exactly what the kernel's
    residency mask leaves out."""
    B, n_pages = table.shape
    pt = pages.shape[1]
    g = pages[table.long()]                       # (B, np, pt, H, D)
    g = g.reshape(B, n_pages * pt, *pages.shape[2:])
    pos = torch.arange(n_pages * pt, device=pages.device)
    live = pos[None, :] < prefix_lens.to(pages.device).long()[:, None]
    g = torch.where(live[:, :, None, None], g, 0.0)
    return g.transpose(1, 2)


def paged_prefix_rank_attn_ref(q, k_pages, v_pages, k_table, v_table,
                               prefix_lens, k_new, v_new, *, n_incr: int,
                               n_total: float = None):
    """The paged twin: gather the prefix K and V through their own page
    tables, then the dense rank oracle over [prefix | new tokens] with
    the prefix length the tables span (``n_pages * page_tokens``)."""
    kp = gather_pages(k_pages, k_table, prefix_lens)
    vp = gather_pages(v_pages, v_table, prefix_lens)
    n_prefix = kp.shape[2]
    return prefix_rank_attn_ref(
        q, torch.cat([kp, k_new], dim=2), torch.cat([vp, v_new], dim=2),
        n_prefix=n_prefix, n_incr=n_incr,
        n_total=n_total or n_prefix + q.shape[2])
