"""The plain reference: an HSTU forward in float32 with plain PyTorch
operations, written from the model's equations, that imports nothing of
the program.

    U, V, Q, K = split(SiLU(f1(rmsnorm(x))))      Q, K rotated (RoPE)
    A          = SiLU(Q K^T / sqrt(d)) / n        (no softmax)
    y          = x + f2(rmsnorm(A V) * U)
    scores     = SiLU(h_items W1) W2

A request's scores come from two passes.  The prefill runs the prefix
tokens (positions 0..n-1, causal, normalizer n) and keeps each layer's
K and V.  The rank runs the short-term tokens and the candidates at
positions ``rank_pos + i``: short-term tokens see the prefix and the
short-term tokens up to their own, a candidate sees the prefix, every
short-term token and itself, and the normalizer is ``rank_pos + Sq``.

``precision`` is the reference's own (``float32``, TF32 off) or the
control's, ``tf32``: every matrix product's inputs rounded to TF32 (10
mantissa bits, to nearest, ties away, as the tensor cores round them),
the products and sums in float32 — the step below float32, alike on
the CPU and the card.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

BLOCK_ROWS = 1024


@contextlib.contextmanager
def tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (the low 13 mantissa bits cleared,
    to nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Reference:
    def __init__(self, w: Dict[str, torch.Tensor], sizes: dict,
                 precision: str = "float32"):
        self.w = w
        self.L, self.d = sizes["n_layers"], sizes["d_model"]
        self.h, self.hd = sizes["n_heads"], sizes["head_dim"]
        self.theta = float(sizes["rope_theta"])
        self.precision = precision

    def mm(self, a, b):
        if self.precision == "tf32":
            a, b = tf32(a), tf32(b)
        return torch.matmul(a, b)

    @staticmethod
    def rms(x, g, eps: float = 1e-6):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g

    def rope(self, x, pos):
        """Interleaved pairs (x[2i], x[2i+1]) rotated by pos * theta^(-2i/D);
        x (S, H, D), pos (S,)."""
        freqs = 1.0 / (self.theta ** (torch.arange(
            0, self.hd, 2, dtype=torch.float32, device=x.device) / self.hd))
        ang = pos.float()[:, None] * freqs                      # (S, D/2)
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., ::2], x[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                           dim=-1).reshape(x.shape)

    def layer(self, l, x, pos, attend):
        w, S = self.w, x.shape[0]
        h, hd = self.h, self.hd
        xn = self.rms(x, w["layers.ln"][l])
        uvqk = F.silu(self.mm(xn, w["layers.uvqk"][l].reshape(
            self.d, 4 * h * hd))).view(S, 4, h, hd)
        u, v = uvqk[:, 0], uvqk[:, 1]
        q, k = self.rope(uvqk[:, 2], pos), self.rope(uvqk[:, 3], pos)
        av = attend(q, k, v)                                    # (S, h, hd)
        av = self.rms(av.reshape(S, h * hd), w["layers.ln_attn"][l])
        y = self.mm((av.view(S, h, hd) * u).reshape(S, h * hd),
                    w["layers.wo"][l].reshape(h * hd, self.d))
        return x + y, k, v

    def scores_hv(self, q, k, v, n_total, keep=None):
        """SiLU(q k^T / sqrt(D)) / n_total, masked by ``keep`` (Sq, Sk),
        times v: q (Sq, H, D), k, v (Sk, H, D) -> (Sq, H, D)."""
        s = self.mm(q.permute(1, 0, 2), k.permute(1, 2, 0)) \
            / math.sqrt(self.hd)
        a = F.silu(s) / n_total
        if keep is not None:
            a = torch.where(keep, a, 0.0)
        return self.mm(a, v.permute(1, 0, 2)).permute(1, 0, 2)

    def prefill(self, tokens):
        """Per-layer (K, V), each (n, H, D), of the prefix tokens."""
        n = tokens.shape[0]
        dev = tokens.device
        pos = torch.arange(n, device=dev)
        x = self.w["tok"][tokens.long()]

        def causal(q, k, v):
            out = torch.empty_like(q)
            for i0 in range(0, n, BLOCK_ROWS):
                i1 = min(n, i0 + BLOCK_ROWS)
                keep = (torch.arange(i1, device=dev)[None, :]
                        <= torch.arange(i0, i1, device=dev)[:, None])
                out[i0:i1] = self.scores_hv(q[i0:i1], k[:i1], v[:i1], n,
                                            keep)
            return out

        kv = []
        for l in range(self.L):
            x, k, v = self.layer(l, x, pos, causal)
            kv.append((k, v))
        return kv

    def rank(self, kv, rank_pos: int, incr, items):
        """Scores (n_items, n_tasks) of the candidates against the
        prefix's (K, V), the fresh tokens at positions rank_pos + i."""
        dev = incr.device
        n_incr, n_items = incr.shape[0], items.shape[0]
        Sq = n_incr + n_items
        x = self.w["tok"][torch.cat([incr, items]).long()]
        pos = rank_pos + torch.arange(Sq, device=dev)
        qi = torch.arange(Sq, device=dev)[:, None]
        kj = torch.arange(Sq, device=dev)[None, :]
        new_keep = torch.where(qi < n_incr, kj <= qi,
                               (kj < n_incr) | (kj == qi))
        n_total = rank_pos + Sq
        for l in range(self.L):
            pk, pv = kv[l]
            keep = torch.cat([torch.ones((Sq, pk.shape[0]), dtype=torch.bool,
                                         device=dev), new_keep], dim=1)

            def attend(q, k, v, pk=pk, pv=pv, keep=keep):
                return self.scores_hv(q, torch.cat([pk, k]),
                                      torch.cat([pv, v]), n_total, keep)

            x, _, _ = self.layer(l, x, pos, attend)
        hi = x[n_incr:]
        return self.mm(F.silu(self.mm(hi, self.w["task_tower.w1"])),
                       self.w["task_tower.w2"])

    @torch.no_grad()
    def scores(self, prefix, rank_pos: int, incr, items):
        with tf32_off():
            return self.rank(self.prefill(prefix), rank_pos, incr, items)


def gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The widest gap of a request's scores, over its largest |score|."""
    program, reference = program.float(), reference.float()
    return float((program - reference).abs().max()
                 / reference.abs().max().clamp_min(1e-30))
