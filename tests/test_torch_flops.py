"""The port's FLOP count of a step (``repro_torch.launch.flops``) against
the reference's jaxpr count (``repro.launch.flops``).

Every arch at smoke size, for its train, prefill and decode steps: the
port's count on ``meta`` equals the reference's where the math is the
same, and each difference is asserted by its formula (ROADMAP Queue 3):

* Mamba2 (``zamba2_1p2b``'s Mamba2 layers): the reference lowers its
  three-operand SSD einsums to pairwise ``dot_general``s, among them
  broadcast products with no contracted dimension, which it counts as
  two FLOPs an output; the port computes those as multiplies, which no
  matmul counter counts.  With one chunk the reference also computes
  three products of zero cotangents through its inter-chunk scan that
  the port's autograd never forms.
* ``attn_q_chunk``: the reference's chunked prefill attends every query
  chunk to all S keys, the port to the keys up to the chunk's end (the
  rest are masked: the same values).
* ``head_pad``: the reference computes the padded heads and zeroes
  them; the port computes the real heads only.

Then the RWKV6 count on meta (its WKV loop as one batched product)
against the loop itself run on the CPU, and a CUDA tensor in every
kernel wrapper reaching its launcher.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.launch.flops import step_flops as ref_step_flops
from repro.launch.steps import make_step as ref_make_step
from repro.models import build_model as rbuild
from repro.models import get_config as rconfig
from repro.models.config import InputShape as RShape
from repro_torch.kernels import (cuda_lib, decode_attn, hstu_attn,
                                 paged_prefix_attn, prefix_rank_attn,
                                 ssd_chunk)
from repro_torch.launch.flops import step_flops
from repro_torch.launch.steps import make_step, step_inputs
from repro_torch.models import ARCH_IDS, build_model, get_config
from repro_torch.models.config import InputShape

B, S = 2, 64


def _counts(arch, kind, b=B, s=S, **override):
    """(reference FLOPs, the port's FLOPs on meta, the port's config)."""
    rc = dataclasses.replace(rconfig(arch, smoke=True), **override)
    pc = dataclasses.replace(get_config(arch, smoke=True), **override)
    fn, sds, _ = ref_make_step(rbuild(rc), RShape("x", s, b, kind))
    ref = int(ref_step_flops(fn, sds))
    shape = InputShape("x", s, b, kind)
    fn, specs, _ = make_step(build_model(pc, device="meta"), shape)
    return ref, step_flops(fn, step_inputs(shape, specs, "meta")), pc


def mamba2_difference(cfg, kind, b, s) -> int:
    """Reference minus port FLOPs of a step over ``cfg.n_layers`` Mamba2
    layers (Queue 3, item 26).  Per layer, H heads of width P, state N:
    forward 2 B L H (N + P) (the SSD state's dt x product and the
    inter-chunk exp(cum) C product); backward 4 B L H (N + P) (each of
    their two operand gradients), plus 6 B L H N P with one chunk; a
    train step runs the forward twice (remat); decode 2 B H N (P + 1)
    (its state update's two broadcast products)."""
    H, N, P, L = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim, cfg.n_layers
    if kind == "decode":
        return L * 2 * b * H * N * (P + 1)
    fwd = 2 * b * s * H * (N + P)
    if kind == "prefill":
        return L * fwd
    one_chunk = s <= 128
    bwd = 4 * b * s * H * (N + P) + (6 * b * s * H * N * P if one_chunk
                                     else 0)
    return L * (2 * fwd + bwd)


def test_flop_count_runs_every_op():
    """A loop of 10 matmuls counts 10 x 2 x 64**3, as the reference's
    counts a ``scan`` of 10 (its ``test_jaxpr_flops_counts_scan_trips``),
    on meta tensors (nothing computed)."""
    def f(x, w):
        for wl in w:
            x = x @ wl
        return x

    x = torch.empty((64, 64), device="meta")
    w = torch.empty((10, 64, 64), device="meta")
    assert step_flops(f, (x, w)) == 10 * 2 * 64 ** 3


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_flops_match_reference(arch, kind):
    """Equal to the reference's count, but for the Mamba2 layers'
    counting difference (zamba2_1p2b), asserted by its formula."""
    ref, got, cfg = _counts(arch, kind)
    want = ref
    if cfg.family == "hybrid":
        want = ref - mamba2_difference(cfg, kind, B, S)
        assert got < ref
    assert got == want, (arch, kind, ref, got)


def test_mamba2_difference_over_two_chunks():
    """At two chunks (L 256, chunk 128) the one-chunk term is gone: the
    train step differs by the broadcast products alone."""
    ref, got, cfg = _counts("zamba2_1p2b", "train", b=1, s=256)
    assert ref - got == mamba2_difference(cfg, "train", 1, 256)


def test_q_chunked_prefill_counts_only_the_keys_it_reads():
    """A prefill with ``attn_q_chunk`` c: per layer and query head the
    reference multiplies every chunk against all S keys (4 B D S^2), the
    port chunk i against its first (i + 1) c keys (4 B D c^2 n(n+1)/2,
    n = S / c); the decode step is untouched (Queue 3, item 27)."""
    c = 16
    ref, got, cfg = _counts("qwen3_4b", "prefill", attn_q_chunk=c)
    n = S // c
    assert ref - got == cfg.n_layers * 4 * B * cfg.n_heads * cfg.head_dim * (
        S * S - c * c * n * (n + 1) // 2)
    ref, got, _ = _counts("qwen3_4b", "decode", attn_q_chunk=c)
    assert ref == got


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_head_pad_counts_the_real_heads(kind):
    """With ``head_pad`` above the head count the port counts what the
    reference counts without the padding: the padded heads' work is the
    whole difference (Queue 3, item 28)."""
    ref_pad, got, cfg = _counts("starcoder2_7b", kind, head_pad=12)
    assert cfg.head_pad > cfg.n_heads
    ref_real, _, _ = _counts("starcoder2_7b", kind, head_pad=0)
    assert got == ref_real < ref_pad


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_rwkv6_meta_count_equals_the_loop(kind):
    """RWKV6's WKV recurrence counted on meta (one batched product of
    the loop's sizes) equals the loop itself run on the CPU under the
    same counter, forward, recompute and backward."""
    cfg = get_config("rwkv6_1p6b", smoke=True)
    shape = InputShape("x", S, B, kind)
    counts = []
    for device in ("meta", "cpu"):
        model = build_model(cfg, device=device)
        if device == "cpu":
            model.init(torch.Generator().manual_seed(0))
        fn, specs, _ = make_step(model, shape)
        args = step_inputs(shape, specs, device)
        counts.append(step_flops(fn, args))
    assert counts[0] == counts[1] > 0


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a wrapper sees of a
    tensor on the card."""

    @property
    def device(self):
        return torch.device("cuda")


def _card(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype).as_subclass(_OnCard)


def test_a_cuda_tensor_still_reaches_the_kernel(monkeypatch):
    """Only CPU and meta tensors take the plain twins: a tensor on the
    card goes to its kernel's launcher in every wrapper (recorded here in
    place of the launch) and counts one launch."""
    calls = []

    def rank(q, k, v, **kw):
        calls.append(("rank_attn", tuple(sorted(kw))))
        return torch.zeros(q.shape)

    def decode(q, k, v, **kw):
        calls.append(("decode_attn",))
        return torch.zeros(q.shape)

    def ssd(kind, Cc, Bc, xc, cum, dtc, out_dtype=None):
        calls.append(("ssd_chunk", kind))
        b, nc, Q, H, P = xc.shape
        return torch.zeros((b, nc, Q, H, P) if kind == "intra"
                           else (b, nc, H, Bc.shape[3], P))

    monkeypatch.setattr(cuda_lib, "rank_attn", rank)
    monkeypatch.setattr(cuda_lib, "decode_attn", decode)
    monkeypatch.setattr(cuda_lib, "ssd_chunk", ssd)
    # the counts this test adds are undone at teardown: a later test in
    # the same process (``serve --segments`` on the CPU) reads them whole
    for mod, attr in ((hstu_attn, "launches"), (prefix_rank_attn, "launches"),
                      (paged_prefix_attn, "launches"),
                      (paged_prefix_attn, "launches_segment"),
                      (decode_attn, "launches"), (ssd_chunk, "launches_intra"),
                      (ssd_chunk, "launches_state")):
        monkeypatch.setattr(mod, attr, getattr(mod, attr))
    counters = lambda: (hstu_attn.launches, prefix_rank_attn.launches,
                        paged_prefix_attn.launches,
                        paged_prefix_attn.launches_segment,
                        decode_attn.launches, ssd_chunk.launches_intra,
                        ssd_chunk.launches_state)
    before = counters()
    q = _card(1, 1, 4, 32)
    pool, rows = _card(2, 4, 1, 32), _card(1, 1, dtype=torch.int32)
    with torch.no_grad():
        hstu_attn.hstu_attn(q, q, q)
        prefix_rank_attn.prefix_rank_attn_split(q, q, q, q, q, n_incr=2)
        paged_prefix_attn.paged_prefix_rank_attn(
            q, pool, pool, rows, rows, _card(1, dtype=torch.int32), q, q,
            n_incr=2)
        paged_prefix_attn.segment_rank_attn(
            q, pool, pool, rows, rows, rows, rows,
            _card(1, 4, dtype=torch.int32), q, q, n_items=2)
        decode_attn.decode_attn(_card(1, 4, 32), _card(1, 8, 2, 32),
                                _card(1, 8, 2, 32))
        c, x, h = _card(1, 1, 8, 16), _card(1, 1, 8, 2, 32), _card(1, 1, 8, 2)
        ssd_chunk.ssd_chunk_intra(c, c, x, h, h)
        ssd_chunk.ssd_chunk_state(c, x, h, h)
    assert calls == [
        ("rank_attn", ("n_incr", "n_total")),
        ("rank_attn", ("n_incr", "n_total", "prefix")),
        ("rank_attn", ("n_incr", "n_total", "pages")),
        ("rank_attn", ("n_incr", "n_total", "pages", "spans")),
        ("decode_attn",), ("ssd_chunk", "intra"), ("ssd_chunk", "state")]
    assert np.subtract(counters(), before).tolist() == [1] * 7
