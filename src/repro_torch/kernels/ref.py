"""Plain-PyTorch twins of ``repro.kernels.ref`` (the correctness contract).

Shapes use the kernel layout (B, H, S, D); ``ops.py`` adapts from the
model layout (B, S, H, D).  These are what every kernel wrapper runs on
CPU and meta tensors (``runs_plain``) and what ``chip_smoke.py`` holds
each CUDA kernel against.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# devices on which a kernel wrapper runs its plain twin: the CPU, and the
# meta device of the dry-run (shapes only: a meta tensor computes
# nothing, so no kernel is hidden from a CUDA caller)
PLAIN_DEVICES = ("cpu", "meta")


def runs_plain(x) -> bool:
    """True where a wrapper runs its plain twin on ``x``; on a CUDA
    tensor it launches its kernel (or raises)."""
    return x.device.type in PLAIN_DEVICES


def _silu_scores(q, k, n_total: float):
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k)
    # float32 scores from 16- or 32-bit inputs, float64 from float64
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    logits = logits * scale
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


def segment_rank_attn_ref(q, k, v, *, q_pos, k_pos, n_items: int,
                          n_total: float = None):
    """Beyond-prefix (segment-reuse) ranking oracle.

    ``k``, ``v``: (B, H, S, D), the full interleaved sequence — cached
    spans and fresh tokens — at global positions ``k_pos`` (B, S).
    Queries are the fresh tokens: ``q`` (B, H, Sq, D) at positions
    ``q_pos`` (B, Sq), the last ``n_items`` of them candidate items.  A
    fresh token sees every key at or before its own position; an item
    sees the non-item context and itself only.  With one cached span at
    [0, P) and fresh tokens at [P, P + Sq) this is
    ``prefix_rank_attn_ref``."""
    Sq = q.shape[2]
    a = _silu_scores(q, k, n_total or k.shape[2])
    qp = q_pos.to(q.device)[:, :, None]                 # (B, Sq, 1)
    kp = k_pos.to(q.device)[:, None, :]                 # (B, 1, S)
    mask = kp <= qp
    if n_items:
        is_item_q = (torch.arange(Sq, device=q.device)
                     >= Sq - n_items)[None, :, None]
        is_item_k = kp >= qp[:, Sq - n_items:Sq - n_items + 1]
        mask = mask & torch.where(is_item_q, ~is_item_k | (kp == qp), True)
    a = torch.where(mask[:, None], a, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", a.to(v.dtype), v)


def _gather(pages, table, live):
    """(B, H, n_pages * page_tokens, D) keys gathered from a (N + 1,
    page_tokens, H, D) pool through a (B, n_pages) page table, zero
    where ``live`` (B, n_pages * page_tokens) is False: a zero key and
    value contribute silu(0) * 0 = 0, exactly what the kernel leaves
    out when it does not read a key."""
    B, n_pages = table.shape
    g = pages[table.long()]                       # (B, np, pt, H, D)
    g = g.reshape(B, n_pages * pages.shape[1], *pages.shape[2:])
    g = torch.where(live[:, :, None, None], g, 0.0)
    return g.transpose(1, 2)


def gather_pages(pages, table, prefix_lens):
    """The prefix gathered through the page table, every key at or past
    the row's ``prefix_lens`` zeroed (the kernel's residency mask)."""
    pos = torch.arange(table.shape[1] * pages.shape[1], device=pages.device)
    live = pos[None, :] < prefix_lens.to(pages.device).long()[:, None]
    return _gather(pages, table, live)


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


HIDDEN = torch.iinfo(torch.int32).max   # position of a key no query sees


def span_key_positions(page_pos, page_valid, page_tokens: int):
    """(B, n_pages * page_tokens) int32 global position of every key of
    a segment launch's table: ``page_pos[b, p] + j`` where the page
    holds the token (``j < page_valid[b, p]``), else ``HIDDEN``."""
    j = torch.arange(page_tokens, dtype=torch.int32, device=page_pos.device)
    pos = page_pos[:, :, None] + j
    pos = torch.where(j < page_valid[:, :, None], pos, HIDDEN)
    return pos.reshape(page_pos.shape[0], -1)


def paged_segment_rank_attn_ref(q, k_pages, v_pages, k_table, v_table,
                                page_pos, page_valid, q_pos, k_new, v_new,
                                *, n_items: int, n_total: float = None):
    """The segment twin: gather the span pages through their K and V
    tables (keys a page does not hold are zero), give each key its
    global position from ``page_pos`` / ``page_valid``, then the
    interleaved oracle over [span keys | fresh tokens] with the fresh
    tokens at ``q_pos``.  ``n_total`` defaults to
    ``n_pages * page_tokens + Sq``."""
    kpos = span_key_positions(page_pos, page_valid, k_pages.shape[1])
    live = kpos != HIDDEN
    kp = _gather(k_pages, k_table, live)
    vp = _gather(v_pages, v_table, live)
    return segment_rank_attn_ref(
        q, torch.cat([kp, k_new], dim=2), torch.cat([vp, v_new], dim=2),
        q_pos=q_pos, k_pos=torch.cat([kpos, q_pos.to(kpos.device)], dim=1),
        n_items=n_items, n_total=n_total or kp.shape[2] + q.shape[2])


def round_tf32(x):
    """``x`` rounded to TF32 (10 explicit mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds; via float32, returned
    in x's type."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(x.dtype)


def silu_attn_f64(q, k, v, mask, *, n_total: float, tf32: bool = False):
    """The SiLU attention of kernels 1-4 in float64, for accuracy probes:
    q (B, H, Sq, D), k and v (B, H, Sk, D), ``mask`` (Sq, Sk) or (B, 1,
    Sq, Sk) bool.  ``tf32`` rounds q, k, v and the masked scores P to
    TF32 before the products, what single-pass TF32 tensor-core products
    would see (their sums kept exact)."""
    q, k, v = (t.double() for t in (q, k, v))
    if tf32:
        q, k, v = map(round_tf32, (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    a = torch.where(mask, F.silu(logits) / n_total, 0.0)
    if tf32:
        a = round_tf32(a)
    return torch.einsum("bhqk,bhkd->bhqd", a, v)


def ssd_chunk_intra_f64(Cc, Bc, xc, cum, dtc, *, tf32: bool = False):
    """``ssd_chunk_intra`` in float64, for accuracy probes: shapes as in
    ``kernels/ssd_chunk.py``, returns (B, nc, Q, H, P) float64.  ``tf32``
    rounds C, B, x and the masked decay matrix M to TF32 before the
    products, what single-pass TF32 tensor-core products would see (their
    sums kept exact).  One batch row at a time, to bound the (Q, Q) per
    head tiles' memory."""
    Q = Cc.shape[2]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=Cc.device).tril()
    rnd = round_tf32 if tf32 else (lambda t: t)
    out = []
    for b in range(Cc.shape[0]):
        C, Bm, x = (rnd(t[b].double()) for t in (Cc, Bc, xc))
        cm, dt = cum[b].double(), dtc[b].double()             # (nc, Q, H)
        scores = torch.einsum("cqn,ckn->cqk", C, Bm)
        dec = (cm[:, :, None, :] - cm[:, None, :, :]).permute(0, 3, 1, 2)
        M = torch.where(causal, torch.exp(torch.where(causal, dec, -math.inf)),
                        0.0) * scores[:, None] * dt.permute(0, 2, 1)[:, :, None, :]
        y = torch.matmul(rnd(M), x.permute(0, 2, 1, 3))         # (nc, H, Q, P)
        out.append(y.permute(0, 2, 1, 3))
    return torch.stack(out)


def decode_attn_ref(q, k, v, lse: bool = False):
    """Softmax flash-decode oracle (GQA), reference signature.

    q: (B, H, D) one query per sequence; k, v: (B, KV, S, D).  Computed
    in float32 throughout from 16- or 32-bit inputs (float64 from
    float64, for accuracy probes) — the softmax weights stay in that
    type before the PV product, as in the Pallas kernel and the CUDA
    kernel — and returned in q's type.  ``lse`` also returns each row's
    ``torch.logsumexp`` of the scaled scores, (B, H), in the compute
    type."""
    B, H, D = q.shape
    KV = k.shape[1]
    ct = torch.promote_types(q.dtype, torch.float32)
    kmap = torch.arange(H, device=k.device) * KV // H
    ke, ve = k[:, kmap].to(ct), v[:, kmap].to(ct)       # (B, H, S, D)
    logits = torch.einsum("bhd,bhsd->bhs", q.to(ct), ke) / math.sqrt(D)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", w, ve).to(q.dtype)
    return (out, torch.logsumexp(logits, dim=-1)) if lse else out
