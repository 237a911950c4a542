"""Operations and bytes of the serve path's work, from its shapes, and
the card's peaks.  A frozen copy of the arithmetic, kept here so that
the yardstick does not move with the program.

Peaks (one H100 SXM, NVIDIA's data sheet, dense): 989e12 FLOP/s in
bfloat16; 165e12 in float32, the 3xTF32 rate on the tensor cores
(495e12 / 3), the fastest that keeps float32's accuracy and the path of
the port's attention kernels; 3.35e12 B/s of HBM.

Attention counts 4 D FLOPs a (query, key) pair and head (Q K^T and A V),
only over the pairs the mask keeps; a kernel's bytes count each input
read once and each output written once.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 165e12, "bfloat16": 989e12}
HBM_BW = 3.35e12
ITEM = {"float32": 4, "bfloat16": 2}
GRID = 64
BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


def grid(n: int) -> int:
    """The prefill's 64-token grid."""
    return max(GRID, (int(n) + GRID - 1) // GRID * GRID)


def bucket(n: int) -> int:
    """The rank launches' prefix bucket."""
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


def batch_grid(n: int, max_batch: int) -> int:
    """A launch's batch rows: the power of two at or above n, at most
    max_batch."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def rank_pairs(prefix: int, n_incr: int, n_items: int) -> int:
    """Short-term tokens see the prefix and the short-term tokens up to
    their own; a candidate sees the prefix, the short-term tokens and
    itself."""
    return (n_incr * prefix + causal_pairs(n_incr)
            + n_items * (prefix + n_incr + 1))


def layer_linear(c: dict) -> int:
    """Projection FLOPs a token and layer: f1 (d -> 4 H D), f2 (H D -> d)."""
    hd = c["n_heads"] * c["head_dim"]
    return 2 * c["d_model"] * 4 * hd + 2 * hd * c["d_model"]


def attn_flops(c: dict, pairs: int) -> int:
    return 4 * c["head_dim"] * c["n_heads"] * pairs


def prefill_flops(c: dict, n: int) -> int:
    """Model FLOPs of a prefill over n tokens (psi of every layer and
    the last position's logits)."""
    vp = (c["vocab"] + 255) // 256 * 256
    return (c["n_layers"] * (n * layer_linear(c)
                             + attn_flops(c, causal_pairs(n)))
            + 2 * c["d_model"] * vp)


def rank_flops(c: dict, prefix: int, n_incr: int, n_items: int) -> int:
    """Model FLOPs of a rank over ``prefix`` cached keys."""
    sq = n_incr + n_items
    d = c["d_model"]
    tower = 2 * n_items * (d * 4 * d + 4 * d * c["n_tasks"])
    return (c["n_layers"] * (sq * layer_linear(c) + attn_flops(
        c, rank_pairs(prefix, n_incr, n_items))) + tower)


def causal_kernel(c: dict, rows: int, s: int):
    """(FLOPs, bytes) of one causal attention launch (rows x S)."""
    e = ITEM[c["dtype"]]
    qkvo = 4 * rows * c["n_heads"] * s * c["head_dim"] * e
    return attn_flops(c, rows * causal_pairs(s)), qkvo


def rank_kernel(c: dict, prefixes, n_incr: int, n_items: int):
    """(FLOPs, bytes) of one rank launch whose rows hold ``prefixes``
    cached keys each (what the mask lets them read)."""
    e = ITEM[c["dtype"]]
    h, hd = c["n_heads"], c["head_dim"]
    sq = n_incr + n_items
    fl = sum(attn_flops(c, rank_pairs(p, n_incr, n_items))
             for p in prefixes)
    by = (4 * len(prefixes) * h * sq * hd + 2 * sum(prefixes) * h * hd) * e
    return fl, by


def bound_s(c: dict, fl: float, by: float) -> float:
    return max(fl / PEAK_FLOPS[c["dtype"]], by / HBM_BW)
