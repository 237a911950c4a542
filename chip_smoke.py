#!/usr/bin/env python3
"""Chip smoke for the PyTorch / Hopper port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card, every phase

Phases, each fatal on failure (nothing is caught):

  1. require ``torch.cuda.is_available()``; print the card's name and
     power limit as ``nvidia-smi`` reports them, and log its UUID and
     SM clocks (now and at most) beside them;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``,
     cached in ``build/kernels/`` by a hash of the sources);
  3. hold each kernel against its plain-PyTorch version on the card at
     the live shapes (B in {1, 8}, H=4, D=64, 2048-token psi, 16 incr +
     64 items), at the paper's ranking shape (64 incr + 512 items over
     2048 tokens) and, for the paged kernel, with 64-token pages and
     ragged per-row lengths; assert the bitwise properties (a row's
     result does not depend on its batch; paged == dense at equal padded
     length; the segment kernel with one span == the paged kernel); the
     segment kernel at B in {1, 8} over a 2048-token prefix span and
     interior spans of 96 and 160 tokens, fresh tokens 8 | 8 | 64 (the
     64 the items), and proof that its limit fails an all-zero output
     and a kernel that ignores the span tables; two calls of each mode
     give the same bits; rows 1-2 at their path shapes within 1e-5 of
     the largest |out| of a float64 version, at inputs N(0, 1) and
     4 N(0, 1), and proof that single-pass TF32 (q, k, v and P rounded
     to TF32) misses that limit; time each kernel per wrapper call
     (``ms``) and per launch by CUDA-graph replay (``graph_ms``), beside
     its FP32 and 3xTF32 bounds, and the plain version per call, with
     CUDA events;
  4. serve 24 requests at full ``hstu-gr`` width through
     ``repro_torch.launch.serve.main`` — live, ``--batched``,
     ``--batched --device-pool``, ``--segments --device-pool`` and
     ``--batched --segments --device-pool`` — every rank and prefill
     launch a CUDA-graph replay (the default), with every launch counter
     zeroed just before and read just after; each kernel of the mode
     must have launched (under ``--segments`` the segment kernel, and
     never the paged one), hits must include ``hbm_hit``, and
     ``serve.main`` asserts that the device pool never re-ships; the
     rank launches of each mode are also tallied by batch size (eager
     launches where they run, each graph replay by its tally) and the
     tally must equal the counters;
  5. the relay-vs-full eps contract at full width, and full-width scores
     on the card against the same weights on the CPU;
  5b. ``graphs``: CUDA graphs against eager launches, in turns — the B=1
     ``rank_with_cache`` (wall, device busy, idle share), the copy of
     dense psi into a graph's static psi, serve's rank p50 / p99 in the
     live and ``--batched --device-pool`` modes (launch counts equal
     between runs whose runtime decided alike), and one fixed sequence
     of executor calls with equal counts and outputs within 1e-6 of the
     largest |value| (bit for bit expected);
  5c. ``costmodel``: ``repro_torch.benchmarks.hardware.measure`` at full
     width — ``LiveExecutor.pre_infer`` / ``rank_cached`` / ``rank_full``
     at 64 incr + 512 items over 1024, 4096 and 16384 prefix tokens, as
     CUDA-graph replays, counters zeroed just before and read just after
     (``hstu_attn`` and ``prefix_rank_attn`` must launch) — and the
     pinned psi copy; the fitted H100 ``HardwareModel`` (``eff_flops``,
     ``h2d_bw``) printed as one JSON line with each point's measured and
     predicted ms, and the simulator's baseline and relay p99 at L 2048,
     60 QPS, 4 s, priced by it (the table is written to
     ``chiprun_out/h100_hardware.json`` and read back by ``hardware.load``);
  6. ``hybrid``: the Zamba2 serve path (``zamba2_1p2b`` at full width and
     depth, bf16, random weights from a seed, LoRA live).  First the
     decode and SSD kernels against their plain twins on the card, at the
     path's shapes and at ragged ones (a ring no split divides, GQA with
     KV in {1, 8, 32} at H 32, one chunk of Q = L < 128) — float32 within
     3e-4 + 3e-4|plain|, bf16 decode within 2**-6 of the largest |plain|
     (about two bf16 ulps; a kernel writing zeros fails), two calls bit
     for bit equal, ``ssd_chunk_intra``'s rows independent of the batch
     and, at the prefill shape, within 1e-5 of the largest |out| of a
     float64 version at the path's decay and a steep one (a limit
     single-pass TF32 misses) — timed per wrapper call beside their
     bound (and row 6's 3xTF32 one), per launch by CUDA-graph replay,
     and, in turns with the kernel, the one PyTorch call that computes
     the same function; then, after a warm-up prefill at the same shape,
     2 prompts x 8192 tokens through
     ``make_prefill_step`` (eager) and 32
     greedy steps through ``make_serve_step`` (a CUDA-graph replay per
     step after the first), counters zeroed
     just before each and read just after (38 + 38 SSD launches per
     prefill, 6 decode launches per step); the decode again eagerly and
     with graphs, in turns, from copies of the post-prefill cache, with
     identical greedy tokens; a profile of one prefill (with the SSD
     kernels' share of its wall) and one decode step each way; and
     card vs CPU logits for a float32 copy at full
     width and 7 layers (one section + a 1-layer tail), prefill plus 4
     decode steps, within 5e-4 of the largest |logit|;
  7. ``train``: HSTU training and decode at full ``hstu-gr`` width.
     ``HSTUAttnFunction`` (the ``hstu_attn`` kernel forward, a float32
     backward) at S 1..4096 x D 32 / 64 against float64 autograd over
     the plain twin, within 1e-5 of each gradient's largest |g|; the
     kernel and the plain backward timed at 8 x 4096 beside their
     bounds; loss and every gradient at 2 layers, 2 x 1024, on the card
     against the port on the CPU in float64 (1e-5 relative, 1e-4 of each
     leaf's largest |g|); then the main path: 8 layers, B 8 x S 4096
     (``train_4k``'s length), 20 AdamW steps through ``make_train_step``
     with the launcher's schedule on ``train_batches(seed=0)``, the
     launch counters zeroed just before and read just after (only
     ``hstu_attn``, two launches a layer and step: the forward and its
     recompute), a finite loss whose last-5 mean is 0.5 below step 0's,
     median ms/step by CUDA events, tokens/s, peak memory (at most 12
     GiB), and one profiled step broken into unembed/CE, the attention
     kernel, its backward, other GEMMs, the optimizer, the embedding and
     the rest; a checkpoint saved, restored
     bit for bit into a fresh model, and two more steps from both within
     1e-6; HSTU ``decode_step`` at B 2 over a 2048-token psi through
     ``make_serve_step`` (graph replays, ``prefix_rank_attn`` counted),
     equal to the eager step bit for bit and within 1e-4 of the largest
     |logit| of the CPU's;
  8. ``lm``: the decoder-only Transformer family's serve path.
     ``decode_attn`` at the family's GQA groups (G 1, 2, 4, 6, 8, 9 —
     starcoder2_7b's 36 real heads of 48 — and 12), D 128, bf16 and
     float32, over rings of 4096 and 8192 slots at B 2, at each served
     run's own heads and ring (bf16), and a decode_32k-like case (qwen3_4b's heads, B 8 x 32768, bf16): against
     the plain twin (as in phase 6) and float64 (float32 within 1e-5,
     bf16 within 2**-8 + 1e-5 of the largest |out|: the output's rounding),
     two calls bit for bit, timed
     per call and by graph beside the byte bound and SDPA.  Then, bf16,
     random weights from a seed: ``qwen3_4b`` at full width and depth
     (36 layers, 4.41 B) — after a warm-up prefill at the same shape,
     2 prompts x 8192 tokens through
     ``make_prefill_step`` (the plain q-chunked attention) and 32 greedy
     steps through ``make_serve_step`` (graphs), counters zeroed just
     before each and read just after (0 ``decode_attn`` launches in the
     prefill, one a layer and step in the decode), then the decode again
     eagerly and with graphs, in turns, from copies of the post-prefill
     cache, with identical greedy tokens (the ring holds the prefill's
     slots, every one live as in the reference, so the decode evicts the
     oldest prompt tokens); ``decode_attn`` against its twin and float64
     on layer 0 of the prefill's cache; prefill ms, ms per step (first,
     later, all), tokens/s, peak memory, the graph pool and each step's
     byte bound (every weight but the embedding table, plus the K/V
     ring); a profiled graph step split by kernel class; the same for
     ``deepseek_moe_16b`` at
     full width cut to 4 of 28 layers (2 x 2048, 32 steps) and
     ``internvl2_2b`` at full width and depth (2 x (256 frontend + 2048),
     8 steps); last, card against CPU for float32 copies of qwen3_4b and
     deepseek_moe_16b at full width and 2 layers (2 x 256 + 4 decode
     steps), logits within 5e-4 of the largest |logit| — 2e-3 for
     deepseek_moe_16b at the reference init (no qk-norm: attention logits
     of std ~128 make float32 reorderings show), where two faults planted
     on the card (TF32 products, the shared experts dropped) must read
     above that limit, and which is also checked with wq / wk rescaled
     to fan-in d at 5e-4;
  9. ``ssm``: the attention-free stacks.  ``rwkv6_1p6b`` at full width
     and depth (24 layers, 1.48 B), bf16: 2 prompts x 2048 tokens
     through ``make_prefill_step`` (after a warm-up at that shape; ms
     per token and layer: the WKV scan is a plain loop over time, as in
     the reference) and 32 greedy steps through ``make_serve_step``
     (graphs), every launch counter zeroed just before each and read
     just after (all 0: RWKV6 reaches no kernel); the decode again
     eagerly and with graphs, in turns, from copies of the post-prefill
     state, with identical greedy tokens; a profiled graph step split
     by kernel class beside its byte bound; the relay property in bf16
     (prefill(P) + decode(token P) within 2**-5 of the largest |logit|
     of prefill(P + 1)); card vs CPU in float32 at 2 layers (2 x 256 +
     4 steps, 5e-4 of the largest |logit|); then an ``ssm_mamba2``
     stack at zamba2_1p2b's widths, 2 layers, float32, 2 x 1024 on the
     card (one ``ssd_chunk_intra`` and one ``ssd_chunk_state`` launch a
     layer) against the CPU (5e-4);
 10. ``encdec``: ``decode_attn`` at seamless's shapes (G 1, D 64, bf16,
     B 2, self ring 2048 and cross 1536 slots) against its twin and
     float64, timed per call and by graph beside SDPA and the byte
     bound; ``seamless_m4t_large_v2`` at full width and depth (24 + 24
     layers, 2.04 B), bf16: 2 x (1536 frames + 2048 tokens) and 32
     greedy steps as in phase 9 (0 ``decode_attn`` launches in the
     prefill, 48 a step: self and cross, every layer), the kernel on
     layer 0 of the prefill's own self and cross cache; card vs CPU in
     float32 at 2 + 2 layers (2 x (1536 + 256) + 4 steps) at the
     reference init (0.1: its attention logits have a std of ~64, so the
     softmax over 1536 frames is near one-hot; a fault planted on the
     card, TF32 products, must read above it) and with wq / wk at
     fan-in d (5e-4);
 11. print the ``kernels`` JSON line, then the final device line; the
     whole run's wall is logged before them.

``--phases`` runs a subset (e.g. ``--phases kernels``) while developing;
the full run takes no arguments.  Per-shape timings are also written to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

TOL = 3e-4          # f32 kernel vs plain: the repo's kernel tolerance
BF16_REL = 2 ** -6  # bf16 decode vs plain: of the largest |plain|, ~2 bf16 ulps
FP32_PEAK = 67e12   # H100 SXM FP32 outside the tensor cores, FLOP/s
TF32_PEAK = 495e12  # H100 SXM dense TF32 tensor cores, FLOP/s
F64_REL = 1e-5      # rank kernels vs float64: of the largest |out|
GRAPH_REL = 1e-6    # graph replay vs eager, of the largest |value|
HBM_BW = 3.35e12    # H100 SXM device memory, B/s
H, D = 4, 64
PSI, N_INCR, N_ITEMS = 2048, 16, 64
PAGE = 64
RAGGED = [2048, 1500, 933, 103, 2048, 640, 1, 1777]   # per-row psi tokens
# per row: ('c', n) a cached span, ('f', n) fresh tokens (the last 64 items)
SEG_PATTERN = [("c", PSI), ("f", 8), ("c", 96), ("f", 8), ("c", 160),
               ("f", N_ITEMS)]

HYB_B, HYB_S, HYB_STEPS = 2, 8192, 32     # prompts, tokens each, decode steps
HYB_CPU_S, HYB_CPU_STEPS = 256, 4         # card-vs-CPU check
HYB_REL = 5e-4                            # card vs CPU, of the largest |logit|

SOURCE = "src/repro_torch/csrc/hstu_rank_attn.cu"
SOURCES = {
    "hstu_attn": SOURCE, "prefix_rank_attn": SOURCE,
    "paged_prefix_rank_attn": SOURCE, "segment_rank_attn": SOURCE,
    "decode_attn": "src/repro_torch/csrc/decode_attn.cu",
    "ssd_chunk_intra": "src/repro_torch/csrc/ssd_chunk.cu",
    "ssd_chunk_state": "src/repro_torch/csrc/ssd_chunk.cu",
}
REPLACES = {
    "hstu_attn": "src/repro/kernels/hstu_attn.py:63",
    "prefix_rank_attn": "src/repro/kernels/prefix_rank_attn.py:67",
    "paged_prefix_rank_attn": "src/repro/kernels/paged_prefix_attn.py:122",
    "segment_rank_attn": "src/repro/kernels/paged_prefix_attn.py:240",
    "decode_attn": "src/repro/kernels/decode_attn.py:59",
    "ssd_chunk_intra": "src/repro/kernels/ssd_chunk.py:51",
    "ssd_chunk_state": "src/repro/kernels/ssd_chunk.py:106",
}


def log(msg):
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


# --- phase 3: kernels against their plain versions ----------------------------


def _time_ms(torch, fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(torch, fn, n=20, reps=5):
    """The card's time per launch of ``fn``: n launches captured in a
    CUDA graph, replayed ``reps`` times between CUDA events, the least of
    3 samples.  No host time is in it (the wrapper runs at capture)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / (n * reps))
    return min(samples)


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _bound_tf32(flops, nbytes):
    """The bound for the arithmetic the rank kernel uses: three TF32
    products per product on the tensor cores."""
    return max(3 * flops / TF32_PEAK, nbytes / HBM_BW) * 1e3


def _rank_times(torch, fn, plain, flops, nbytes):
    """A rank kernel's times at one shape: ``ms`` back-to-back wrapper
    calls (host included, as every kernel here is timed), ``graph_ms``
    the card's time per launch (CUDA-graph replay, no host), the plain
    twin per call, and both bounds."""
    bound_ms, by = _bound(flops, nbytes)
    return dict(ms=_time_ms(torch, fn), graph_ms=_graph_ms(torch, fn),
                plain_ms=_time_ms(torch, plain, 5), bound_ms=bound_ms,
                bound_by=by, bound_tf32_ms=_bound_tf32(flops, nbytes))


def _visible_new(Sq, n_incr):
    """(query, key) pairs the rank mask keeps among the new tokens."""
    incr = n_incr * (n_incr + 1) // 2
    items = (Sq - n_incr) * (n_incr + 1)
    return incr + items


def kernel_phase(torch, results):
    from repro_torch.kernels import hstu_attn as hk
    from repro_torch.kernels import paged_prefix_attn as pk
    from repro_torch.kernels import prefix_rank_attn as rk
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def check(name, got, want):
        err = (got - want).abs()
        lim = TOL + TOL * want.abs()
        assert torch.isfinite(got).all(), f"{name}: non-finite output"
        assert bool((err <= lim).all()), (
            f"{name}: |kernel - plain| {err.max().item():.3e} over "
            f"{TOL} + {TOL}|plain|")
        e = err.max().item()
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)
        return e

    # hstu_attn: the causal prefill, psi 2048 and a ragged length
    for B, S in ((1, PSI), (8, PSI), (2, 933)):
        q, k, v = randn(B, H, S, D), randn(B, H, S, D), randn(B, H, S, D)
        got = hk.hstu_attn(q, k, v)
        e = check("hstu_attn", got, hk.hstu_attn_plain(q, k, v))
        if B == 8:                       # bitwise: a row ignores its batch
            for b in range(B):
                one = hk.hstu_attn(q[b:b + 1], k[b:b + 1], v[b:b + 1])
                assert torch.equal(one[0], got[b]), "hstu_attn: batch-dependent row"
        assert torch.equal(hk.hstu_attn(q, k, v), got), "hstu_attn: two calls differ"
        pairs = B * H * S * (S + 1) // 2
        flops, nbytes = 4 * D * pairs, 4 * 4 * B * H * S * D
        t = _rank_times(torch, lambda: hk.hstu_attn(q, k, v),
                        lambda: hk.hstu_attn_plain(q, k, v), flops, nbytes)
        results["hstu_attn"]["shapes"].append(dict(
            B=B, S=S, main=(B, S) == (8, PSI), max_abs_err=e, **t))
        log(f"hstu_attn B={B} S={S}: err {e:.2e} kernel {t['ms']:.4f} ms "
            f"(graph {t['graph_ms']:.4f}) plain {t['plain_ms']:.4f} ms bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), 3xTF32 "
            f"{t['bound_tf32_ms']:.4f} ms")

    # prefix_rank_attn + paged: live shapes and the paper's ranking shape
    for B, n_incr, n_items in ((1, N_INCR, N_ITEMS), (8, N_INCR, N_ITEMS),
                               (1, 64, 512)):
        Sq = n_incr + n_items
        lens = RAGGED[:B] if B > 1 else [PSI]
        q, kn, vn = randn(B, H, Sq, D), randn(B, H, Sq, D), randn(B, H, Sq, D)
        n_pages = PSI // PAGE
        # a pool whose K and V pages are distinct and shuffled, null last
        n_pool = 2 * B * n_pages
        pool = randn(n_pool + 1, PAGE, H, D)
        pool[n_pool] = 0
        perm = torch.randperm(n_pool, generator=gen, device=dev).int()
        kt = torch.full((B, n_pages), n_pool, dtype=torch.int32, device=dev)
        vt = kt.clone()
        for b, ln in enumerate(lens):
            used = -(-ln // PAGE)
            base = 2 * b * n_pages
            kt[b, :used] = perm[base:base + used]
            vt[b, :used] = perm[base + n_pages:base + n_pages + used]
        plens = torch.tensor(lens, dtype=torch.int32, device=dev)
        # the dense twin: the same prefix gathered and zero-padded to PSI
        kp = ref.gather_pages(pool, kt, plens)
        vp = ref.gather_pages(pool, vt, plens)

        dense = rk.prefix_rank_attn_split(q, kp, vp, kn, vn, n_incr=n_incr)
        e_d = check("prefix_rank_attn", dense, rk.prefix_rank_attn_plain(
            q, torch.cat([kp, kn], 2), torch.cat([vp, vn], 2),
            n_prefix=PSI, n_incr=n_incr))
        paged = pk.paged_prefix_rank_attn(q, pool, pool, kt, vt, plens, kn,
                                          vn, n_incr=n_incr)
        e_p = check("paged_prefix_rank_attn", paged,
                    pk.paged_prefix_rank_attn_plain(
                        q, pool, pool, kt, vt, plens, kn, vn, n_incr=n_incr))
        # bitwise: paged == dense at the same padded length (64-key tiles
        # are the 64-token pages), and rows independent of the batch
        assert torch.equal(paged, dense), (
            f"paged != dense bitwise (max {(paged - dense).abs().max():.3e})")
        # bitwise: one span at [0, prefix_len), fresh tokens after it,
        # through the segment kernel == the paged kernel
        ppos = (torch.arange(n_pages, dtype=torch.int32, device=dev) * PAGE
                ).expand(B, n_pages).contiguous()
        pval = (plens[:, None] - ppos).clamp(0, PAGE).int()
        qpos = (PSI + torch.arange(Sq, dtype=torch.int32, device=dev)
                ).expand(B, Sq)
        seg = pk.segment_rank_attn(q, pool, pool, kt, vt, ppos, pval, qpos,
                                   kn, vn, n_items=n_items)
        assert torch.equal(seg, paged), (
            f"segment (one span) != paged bitwise "
            f"(max {(seg - paged).abs().max():.3e})")
        # bitwise: two calls on the same inputs, every mode
        for mode, again, first in (
                ("dense", lambda: rk.prefix_rank_attn_split(
                    q, kp, vp, kn, vn, n_incr=n_incr), dense),
                ("paged", lambda: pk.paged_prefix_rank_attn(
                    q, pool, pool, kt, vt, plens, kn, vn, n_incr=n_incr), paged),
                ("segment", lambda: pk.segment_rank_attn(
                    q, pool, pool, kt, vt, ppos, pval, qpos, kn, vn,
                    n_items=n_items), seg)):
            assert torch.equal(again(), first), f"{mode}: two calls differ"
        if B > 1:
            for b in range(B):
                s = slice(b, b + 1)
                one_d = rk.prefix_rank_attn_split(q[s], kp[s], vp[s], kn[s],
                                                  vn[s], n_incr=n_incr)
                one_p = pk.paged_prefix_rank_attn(
                    q[s], pool, pool, kt[s], vt[s], plens[s], kn[s], vn[s],
                    n_incr=n_incr)
                assert torch.equal(one_d[0], dense[b]), "dense: batch-dependent row"
                assert torch.equal(one_p[0], paged[b]), "paged: batch-dependent row"
        new_pairs = B * H * _visible_new(Sq, n_incr)
        for name, fn, plain, e, pre_keys in (
                ("prefix_rank_attn",
                 lambda: rk.prefix_rank_attn_split(q, kp, vp, kn, vn,
                                                   n_incr=n_incr),
                 lambda: rk.prefix_rank_attn_plain(
                     q, torch.cat([kp, kn], 2), torch.cat([vp, vn], 2),
                     n_prefix=PSI, n_incr=n_incr),
                 e_d, B * PSI),
                ("paged_prefix_rank_attn",
                 lambda: pk.paged_prefix_rank_attn(q, pool, pool, kt, vt,
                                                   plens, kn, vn,
                                                   n_incr=n_incr),
                 lambda: pk.paged_prefix_rank_attn_plain(
                     q, pool, pool, kt, vt, plens, kn, vn, n_incr=n_incr),
                 e_p, sum(lens))):
            pairs = new_pairs + H * Sq * pre_keys
            flops = 4 * D * pairs
            nbytes = 4 * (4 * B * H * Sq * D + 2 * pre_keys * H * D)
            if name == "paged_prefix_rank_attn":
                nbytes += 4 * (2 * B * n_pages + B)     # tables + lengths
            t = _rank_times(torch, fn, plain, flops, nbytes)
            results[name]["shapes"].append(dict(
                B=B, P=PSI, n_incr=n_incr, n_items=n_items,
                main=(B, n_incr) == (8, N_INCR), max_abs_err=e,
                prefix_tokens=pre_keys, **t))
            log(f"{name} B={B} P={PSI} Sq={Sq}: err {e:.2e} kernel "
                f"{t['ms']:.4f} ms (graph {t['graph_ms']:.4f}) plain "
                f"{t['plain_ms']:.4f} ms bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}), 3xTF32 {t['bound_tf32_ms']:.4f} ms")
    segment_checks(torch, results, gen, check)
    f32_accuracy(torch, results)
    log("kernels agree with their plain versions; bitwise properties hold")


def f32_accuracy(torch, results):
    """Rows 1-2 at their path shapes against float64, within F64_REL of
    the largest |out|, at inputs N(0, 1) and 4 N(0, 1) (SiLU out of its
    linear range); and proof that the limit fails single-pass TF32: the
    float64 version with q, k, v and P rounded to TF32 misses it."""
    from repro_torch.kernels import hstu_attn as hk
    from repro_torch.kernels import prefix_rank_attn as rk
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(3)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    causal = torch.ones(PSI, PSI, dtype=torch.bool, device="cuda").tril()
    rank = ref.rank_mask_ref(PSI, N_INCR, N_ITEMS, device="cuda")
    Sq = N_INCR + N_ITEMS
    for scale in (1.0, 4.0):
        cases = []
        q, k, v = (scale * randn(1, H, PSI, D) for _ in range(3))
        cases.append(("hstu_attn", hk.hstu_attn(q, k, v), (q, k, v), causal,
                      PSI))
        q, kn, vn = (scale * randn(8, H, Sq, D) for _ in range(3))
        kp, vp = (scale * randn(8, H, PSI, D) for _ in range(2))
        cases.append(("prefix_rank_attn", rk.prefix_rank_attn_split(
            q, kp, vp, kn, vn, n_incr=N_INCR),
            (q, torch.cat([kp, kn], 2), torch.cat([vp, vn], 2)), rank,
            PSI + Sq))
        for name, got, qkv, mask, n in cases:
            want = ref.silu_attn_f64(*qkv, mask, n_total=n)
            top = want.abs().max().item()
            err = (got.double() - want).abs().max().item() / top
            tf32 = (ref.silu_attn_f64(*qkv, mask, n_total=n, tf32=True)
                    - want).abs().max().item() / top
            assert err <= F64_REL, (
                f"{name} x{scale:g}: |kernel - float64| {err:.2e} of max "
                f"|out| over {F64_REL}")
            assert tf32 > F64_REL, (
                f"{name} x{scale:g}: TF32 errs {tf32:.2e}, inside the limit")
            results[name].setdefault("f64_rel", {})[f"x{scale:g}"] = dict(
                kernel=err, tf32=tf32)
            log(f"{name} x{scale:g} vs float64: kernel {err:.2e}, single-pass "
                f"TF32 {tf32:.2e} of max |out| (limit {F64_REL})")


def _segment_inputs(torch, gen, B):
    """SEG_PATTERN in every row of B, at 64-token pages of one pool
    whose K and V pages are distinct and shuffled (the null page last,
    zero).  Values are SiLU-shaped, silu(2 N(0, 1)), as the model's own
    q, k and v are (HSTU passes them through SiLU), so the cached spans
    move the output well past the limit; the tail of a partly held page
    is data too, which the kernel must not read."""
    dev = torch.device("cuda")
    act = lambda *shape: torch.nn.functional.silu(
        2 * torch.randn(shape, generator=gen, device=dev))
    spans, fresh, pos = [], [], 0
    for kind, n in SEG_PATTERN:
        if kind == "c":
            spans.append((pos, n))
        else:
            fresh.extend(range(pos, pos + n))
        pos += n
    pp, pv = [], []
    for start, n in spans:
        for lo in range(0, n, PAGE):
            pp.append(start + lo)
            pv.append(min(PAGE, n - lo))
    n_pages, Sq = len(pp), len(fresh)
    n_pool = 2 * B * n_pages
    pool = act(n_pool + 1, PAGE, H, D)
    pool[n_pool] = 0
    perm = torch.randperm(n_pool, generator=gen, device=dev).int()
    rows = lambda a: torch.tensor([a] * B, dtype=torch.int32, device=dev)
    return dict(q=act(B, H, Sq, D), k_pages=pool, v_pages=pool,
                k_table=perm[:B * n_pages].view(B, n_pages),
                v_table=perm[B * n_pages:].view(B, n_pages),
                page_pos=rows(pp), page_valid=rows(pv), q_pos=rows(fresh),
                k_new=act(B, H, Sq, D), v_new=act(B, H, Sq, D),
                n_items=N_ITEMS)


def segment_checks(torch, results, gen, check):
    """segment_rank_attn at B in {1, 8}: against its plain twin, a row
    against its batch, a limit that an all-zero output and a kernel
    ignoring the span tables would fail, and times beside the bound."""
    from repro_torch.kernels import paged_prefix_attn as pk
    from repro_torch.kernels import ref

    name = "segment_rank_attn"
    for B in (1, 8):
        a = _segment_inputs(torch, gen, B)
        plain = lambda **kw: pk.segment_rank_attn_plain(**{**a, **kw})
        got = pk.segment_rank_attn(**a)
        want = plain()
        e = check(name, got, want)
        lim = TOL + TOL * want.abs()
        zero = (want.abs() > lim).float().mean().item()
        assert zero > 0.5, f"{name}: an all-zero output fails only {zero:.3f}"
        full = torch.full_like(a["page_valid"], PAGE)
        flat = torch.zeros_like(a["page_pos"])
        margins = {k: ((plain(**kw) - want).abs() / lim).max().item()
                   for k, kw in (("page_valid", dict(page_valid=full)),
                                 ("page_pos", dict(page_pos=flat)),
                                 ("all_visible", dict(page_valid=full,
                                                      page_pos=flat)))}
        assert margins["all_visible"] > 100, margins
        assert min(margins.values()) > 10, margins
        if B > 1:
            for b in range(B):
                one = pk.segment_rank_attn(**{
                    k: v[b:b + 1] if torch.is_tensor(v) and v is not
                    a["k_pages"] else v for k, v in a.items()})
                assert torch.equal(one[0], got[b]), f"{name}: batch-dependent row"
        # the work these inputs need: the (query, cached key) pairs the
        # span mask keeps, the new-token pairs the rank mask keeps; the
        # held cached keys, q/k/v/out, the four tables and q_pos moved once
        kpos = ref.span_key_positions(a["page_pos"], a["page_valid"], PAGE)
        Sq = a["q"].shape[2]
        cached = (kpos[:, None, :] <= a["q_pos"][:, :, None]).sum().item()
        held = (kpos != ref.HIDDEN).sum().item()
        pairs = H * (cached + B * _visible_new(Sq, Sq - N_ITEMS))
        flops = 4 * D * pairs
        nbytes = 4 * (4 * B * H * Sq * D + 2 * held * H * D
                      + 4 * a["k_table"].numel() + B * Sq)
        t = _rank_times(torch, lambda: pk.segment_rank_attn(**a), plain,
                        flops, nbytes)
        assert torch.equal(pk.segment_rank_attn(**a), got), \
            f"{name}: two calls differ"
        results[name]["shapes"].append(dict(
            B=B, P=PSI, n_incr=Sq - N_ITEMS, n_items=N_ITEMS,
            spans=[n for kind, n in SEG_PATTERN if kind == "c"],
            main=B == 8, max_abs_err=e, zero_fails=zero,
            wrong_mask_margins=margins, **t))
        log(f"{name} B={B} spans {results[name]['shapes'][-1]['spans']} "
            f"Sq={Sq}: err {e:.2e} kernel {t['ms']:.4f} ms (graph "
            f"{t['graph_ms']:.4f}) plain {t['plain_ms']:.4f} ms bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), 3xTF32 "
            f"{t['bound_tf32_ms']:.4f} ms; all-zero fails {zero:.3f}, "
            f"wrong-mask margins (x limit) " + ", ".join(
                f"{k} {v:.1f}" for k, v in margins.items()))


# --- phase 4: the main path ------------------------------------------------------


def _batch_mix(torch, cuda_lib, graphs):
    """Tally each rank launch by kernel and batch size into the returned
    dict; the caller calls the returned ``restore``.  An eager launch is
    seen at ``cuda_lib.rank_attn`` (a call made while a CUDA graph is
    being captured runs nothing and is skipped); a graph replay adds its
    graph's tally at the graph's batch (``graphs.Graph.replay`` is
    wrapped too).  The wrappers' own counters are untouched."""
    launch, replay, mix = cuda_lib.rank_attn, graphs.Graph.replay, {}

    def add(kind, B, n):
        by_b = mix.setdefault(kind, {})
        by_b[f"B{B}"] = by_b.get(f"B{B}", 0) + n

    def tally(q, *args, prefix=None, pages=None, spans=None, **kw):
        out = launch(q, *args, prefix=prefix, pages=pages, spans=spans, **kw)
        if not torch.cuda.is_current_stream_capturing():
            add("segment_rank_attn" if spans is not None else
                "paged_prefix_rank_attn" if pages is not None else
                "prefix_rank_attn" if prefix is not None else "hstu_attn",
                q.shape[0], 1)
        return out

    def replayed(self, *args, **kw):
        out = replay(self, *args, **kw)
        for kind, n in self.tally.items():
            add(kind, self.batch, n)
        return out

    def restore():
        cuda_lib.rank_attn, graphs.Graph.replay = launch, replay

    cuda_lib.rank_attn, graphs.Graph.replay = tally, replayed
    return restore, mix


RANK_COUNTERS = ("hstu_attn", "prefix_rank_attn", "paged_prefix_rank_attn",
                 "segment_rank_attn")


def serve_run(torch, flags, requests):
    """One full-width ``serve.main`` run with every launch counter zeroed
    just before and read just after: (hits, launches by kernel, rank
    launches by kernel and batch size, rank compute ms per request, the
    graph runner's captures and pool bytes, wall s)."""
    import numpy as np
    from repro_torch.core import graphs
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import serve

    graphs.write_counters({n: 0 for n in graphs.COUNTERS})
    restore, mix = _batch_mix(torch, cuda_lib, graphs)
    summary = {}
    t0 = time.perf_counter()
    try:
        # serve.main asserts launch_reships == 0 under --device-pool
        hits = serve.main(["--no-smoke", "--device", "cuda", "--requests",
                           str(requests), *flags], summary)
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    counts = {n: c for n, c in graphs.read_counters().items()
              if n in RANK_COUNTERS}
    for n, c in counts.items():
        assert sum(mix.get(n, {}).values()) == c, (
            f"{flags}: {n} counted {c} launches, tallied {mix.get(n)}")
    lat = summary["rank_ms"]
    runner = summary["graphs"]
    return dict(hits=hits, launches=counts, by_batch=mix, wall_s=wall,
                requests=requests, rank_ms=lat, batch=summary.get("batch"),
                p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)),
                graphs=None if runner is None else dict(
                    runner.captures, pool_bytes=runner.pool_bytes(),
                    keys=len(runner.graphs)))


def serve_phase(torch, results, requests):
    seg_must = ("hstu_attn", "segment_rank_attn")
    # (mode, flags, kernels that must launch, kernels that must not)
    modes = (("live", [], ("hstu_attn", "prefix_rank_attn"), ()),
             ("batched", ["--batched"], ("hstu_attn", "prefix_rank_attn"), ()),
             ("batched-device-pool", ["--batched", "--device-pool"],
              ("hstu_attn", "paged_prefix_rank_attn"), ("segment_rank_attn",)),
             ("segments-device-pool", ["--segments", "--device-pool"],
              seg_must, ("paged_prefix_rank_attn",)),
             ("batched-segments-device-pool",
              ["--batched", "--segments", "--device-pool"], seg_must,
              ("paged_prefix_rank_attn",)))
    for mode, flags, must, must_not in modes:
        r = serve_run(torch, flags, requests)
        hits, counts = r["hits"], r["launches"]
        log(f"serve {mode}: {r['wall_s']:.1f} s hits={hits} launches={counts} "
            f"rank p50 {r['p50_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms, "
            f"graphs {r['graphs']}")
        log(f"serve {mode}: launches by batch size {r['by_batch']}")
        assert r["graphs"] is not None, f"{mode}: served without graphs"
        assert hits.get("hbm_hit", 0) > 0, f"{mode}: no hbm_hit in {hits}"
        for n in must:
            assert counts[n] > 0, f"{mode}: {n} never launched"
        for n in must_not:
            assert counts[n] == 0, f"{mode}: {n} launched {counts[n]} times"
        for n, c in counts.items():
            results[n]["launches"] += c
        results["_serve"][mode] = r
    for n in RANK_COUNTERS:
        assert results[n]["launches"] > 0, f"{n} never launched on the main path"


# --- phase 5: eps contract + card vs CPU ------------------------------------------


def relay_phase(torch, results):
    import numpy as np
    from repro_torch.models import build_model, get_config

    cfg = get_config("hstu-gr")
    gpu = build_model(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab, (1, 1024))
    incr = rng.integers(0, cfg.vocab, (1, N_INCR))
    items = rng.integers(0, cfg.vocab, (1, N_ITEMS))
    on = lambda a, m: torch.as_tensor(a, device=m.device)
    _, psi = gpu.prefill({"tokens": on(prefix, gpu)})
    relay = gpu.rank_with_cache(psi, on(incr, gpu), on(items, gpu))
    full = gpu.full_rank(on(prefix, gpu), on(incr, gpu), on(items, gpu))
    eps = (relay - full).abs().max().item()
    assert relay.shape == (1, N_ITEMS, cfg.n_tasks), relay.shape
    assert torch.isfinite(relay).all()
    assert eps < 1e-4, f"|relay - full| = {eps}"
    ref = cpu.full_rank(on(prefix, cpu), on(incr, cpu), on(items, cpu))
    diff = (full.cpu() - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert diff <= 1e-4 * max(scale, 1.0), (
        f"card vs CPU scores differ by {diff} (max |score| {scale})")
    log(f"relay eps {eps:.2e}; card vs CPU max diff {diff:.3e} "
        f"(max |score| {scale:.3e})")
    results["_relay"] = dict(eps=eps, card_vs_cpu=diff, max_score=scale)
    results["_breakdown"] = breakdown(torch, gpu, psi, on(incr, gpu),
                                      on(items, gpu))


def breakdown(torch, model, psi, incr, items, iters=5):
    """Where one full-width rank_with_cache (B=1, 1024-token psi, 16 incr
    + 64 items) spends its time: wall time by CUDA events, device time
    by kernel from torch.profiler, and the share the device sits idle."""
    for _ in range(3):
        model.rank_with_cache(psi, incr, items)
    return profile_fn(torch, "rank_with_cache",
                      lambda: model.rank_with_cache(psi, incr, items), iters)


def profile_fn(torch, label, fn, iters):
    """Wall time of ``fn`` by CUDA events, its device time by kernel from
    torch.profiler, and the share of the wall time the device is idle."""
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_kernel, by_host = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):              # kernels only
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            by_kernel[e.key] = t / 1e3 / iters
        elif e.self_cpu_time_total > 0:
            by_host[e.key] = e.self_cpu_time_total / 1e3 / iters
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    host = sorted(by_host.items(), key=lambda kv: -kv[1])[:6]
    idle = max(0.0, 1 - busy / wall_ms) if busy else float("nan")
    log(f"breakdown {label}: wall {wall_ms:.4f} ms, device busy "
        f"{busy:.4f} ms, idle share {idle:.3f}")
    for name, ms in top:
        log(f"  device {ms:.4f} ms  {name[:90]}")
    for name, ms in host:
        log(f"  host   {ms:.4f} ms  {name[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=idle, top=top,
                host=host, kernels=by_kernel)


# --- phase 5b: CUDA graphs against eager launches ---------------------------------


def graphs_phase(torch, results, requests):
    """Graphs (the default) against eager launches, in turns: the B=1
    full-width ``rank_with_cache`` (wall, device busy, idle share; the
    graph path copies psi into its static input), the copy of dense psi
    into a graph's static psi, and serve's rank p50 / p99 in the live
    and ``--batched --device-pool`` modes with equal per-kernel launch
    counts.  The hybrid decode's comparison runs in the hybrid phase."""
    import numpy as np
    from repro_torch.core.graphs import GraphRunner
    from repro_torch.models import build_model, get_config
    from repro_torch.serving.batching import stack_psi

    out = results.setdefault("_graphs", {})
    cfg = get_config("hstu-gr")
    model = build_model(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    on = lambda a: torch.as_tensor(a, device="cuda")
    _, psi = model.prefill({"tokens": on(rng.integers(0, cfg.vocab, (1, 1024)))})
    incr = on(rng.integers(0, cfg.vocab, (1, N_INCR)))
    items = on(rng.integers(0, cfg.vocab, (1, N_ITEMS)))
    runner = GraphRunner("cuda")
    key = ("rank", 1, 1024, N_INCR, N_ITEMS)
    graph = lambda: runner.run(key, model.rank_with_cache, (psi, incr, items))
    eager = lambda: model.rank_with_cache(psi, incr, items)
    want = eager()
    for _ in range(3):
        graph()
        eager()
    assert torch.equal(graph(), want), "rank_with_cache: replay != eager"
    prof = {"eager": [], "graphs": []}
    for who in ("eager", "graphs", "graphs", "eager"):
        prof[who].append(profile_fn(torch, f"rank_with_cache B=1 ({who})",
                                    graph if who == "graphs" else eager, 5))
    out["rank_b1"] = {k: [{f: p[f] for f in ("wall_ms", "busy_ms",
                                               "idle_share")} for p in v]
                      for k, v in prof.items()}
    # the copy of dense psi into a graph's static psi: one user at bucket
    # 2048 (L x 2 x 2048 x H x D float32), and a B=8 group through
    # stack_psi into the static buffer (members of 2048 tokens)
    user = tuple(torch.randn((cfg.n_layers, 1, 2048, cfg.n_heads,
                              cfg.head_dim), device="cuda") for _ in range(2))
    static1 = tuple(torch.empty_like(a) for a in user)
    static8 = tuple(torch.empty((cfg.n_layers, 8, 2048, cfg.n_heads,
                                 cfg.head_dim), device="cuda")
                    for _ in range(2))
    nbytes = sum(a.numel() * a.element_size() for a in user)
    copy1 = _time_ms(torch, lambda: [s.copy_(a) for s, a in
                                      zip(static1, user)])
    copy8 = _time_ms(torch, lambda: stack_psi([user] * 8, 2048, out=static8))
    out["psi_copy"] = dict(bytes_per_user=nbytes, b1_ms=copy1, b8_ms=copy8,
                           b1_bytes_bound_ms=2 * nbytes / HBM_BW * 1e3)
    log(f"psi copy into the static psi: B=1 at 2048 ({nbytes / 1e6:.1f} MB) "
        f"{copy1:.4f} ms, B=8 group {copy8:.4f} ms (read + write bound "
        f"{2 * nbytes / HBM_BW * 1e3:.4f} ms a user)")
    del user, static1, static8, model, psi, runner

    # serve: graphs and eager in turns, g e e g (the first g is the serve
    # phase's run where it ran), the same stream each time
    for mode, flags in (("live", []),
                        ("batched-device-pool", ["--batched", "--device-pool"])):
        runs = {"graphs": [], "eager": []}
        first = results["_serve"].get(mode)
        order = ("eager", "eager", "graphs") if first else \
            ("graphs", "eager", "eager", "graphs")
        if first:
            runs["graphs"].append(first)
        for who in order:
            runs[who].append(serve_run(
                torch, flags + (["--no-graphs"] if who == "eager" else []),
                requests))
        # the runtime reads the measured latencies (the relay race, the
        # batch slots), so a run may take other decisions than another:
        # counts are held equal between runs that decided alike (same
        # hits, same rank and prefill batches); the executor check below
        # holds them equal on one fixed call sequence
        ref = runs["graphs"][0]
        alike = []
        for who, rs in runs.items():
            for r in rs:
                assert (r["graphs"] is None) == (who == "eager")
                if (r["hits"], r["batch"]) == (ref["hits"], ref["batch"]):
                    assert r["launches"] == ref["launches"], (
                        f"{mode}: {who} counted {r['launches']}, graphs "
                        f"{ref['launches']} on the same decisions")
                    alike.append(who)
        out[mode] = {who: [{f: r[f] for f in ("p50_ms", "p99_ms", "wall_s",
                                              "graphs", "launches", "hits")}
                           for r in rs] for who, rs in runs.items()}
        out[mode]["alike"] = alike
        log(f"graphs {mode}: rank p50 / p99 ms, graphs " + ", ".join(
            f"{r['p50_ms']:.4f} / {r['p99_ms']:.4f}" for r in runs["graphs"])
            + "; eager " + ", ".join(
            f"{r['p50_ms']:.4f} / {r['p99_ms']:.4f}" for r in runs["eager"])
            + f"; launches " + ", ".join(str(r["launches"]) for rs in
                                        runs.values() for r in rs)
            + f" (runs deciding alike, counts equal: {alike}); graph pool "
            f"{[r['graphs']['pool_bytes'] for r in runs['graphs']]} B")
    executor_counts(torch, out)


def executor_counts(torch, out):
    """One fixed sequence of executor calls at full width — warm-up,
    prefill of single users and of a group, dense rank and full rank per
    user, and groups of 1, 2, 3 and 8 — through a ``batched`` executor
    with graphs and one without: every per-kernel launch count equal, and
    every output equal bit for bit."""
    from repro_torch.core import BatchingConfig, UserMeta, get_executor
    from repro_torch.core.graphs import read_counters, write_counters
    from repro_torch.data.synthetic import UserBehaviorStore, WorkloadConfig
    from repro_torch.models import build_model, get_config
    from repro_torch.serving.batching import PendingRank

    cfg = get_config("hstu-gr")
    model = build_model(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    store = UserBehaviorStore(WorkloadConfig(
        vocab=cfg.vocab, n_items=N_ITEMS, incr_len=N_INCR, max_len=2048))
    metas = [UserMeta(user_id=u, prefix_len=n, incr_len=N_INCR,
                      n_items=N_ITEMS)
             for u, n in enumerate((300, 700, 1500, 2048, 100, 64, 900, 1200))]
    twins = [UserMeta(user_id=100 + u, prefix_len=n, incr_len=N_INCR,
                      n_items=N_ITEMS) for u, n in enumerate((290, 300, 270))]

    def drive(graphs):
        ex = get_executor("batched")(model, store,
                                     batching=BatchingConfig(max_batch=8),
                                     graphs=graphs)
        write_counters({n: 0 for n in read_counters()})
        ex.warmup([m.prefix_len for m in metas], batch_sizes=(1, 2, 4, 8),
                  incr_len=N_INCR, n_items=N_ITEMS)
        outs = []
        psis = [ex.pre_infer(m)[0] for m in metas]
        outs += psis
        for _ in range(2):
            outs += [psi for psi, _ in ex.pre_infer_group(twins)[0]]
            for m, psi in zip(metas, psis):
                outs.append(ex.rank_cached(m, psi)[0])
                outs.append(ex.rank_full(m)[0])
            for n in (1, 2, 3, 8):
                for cached in (True, False):
                    group = [PendingRank(user_id=m.user_id,
                                         psi=psi if cached else None,
                                         prefix_len=m.prefix_len, meta=m)
                             for m, psi in zip(metas[:n], psis[:n])]
                    outs += ex.rank_group(group)[0]
        torch.cuda.synchronize()
        return outs, read_counters(), ex.graphs

    g_outs, g_counts, runner = drive(None)
    e_outs, e_counts, _ = drive(False)
    assert g_counts == e_counts, f"graphs {g_counts} != eager {e_counts}"
    from repro_torch.core.graphs import tensor_leaves
    diff = max((a - b).abs().max().item() for a, b in zip(
        tensor_leaves(g_outs), tensor_leaves(e_outs)))
    top = max(b.abs().max().item() for b in tensor_leaves(e_outs))
    # bit for bit unless cuBLAS picks another algorithm under capture;
    # then within 1e-6 of the largest |value|
    assert diff <= GRAPH_REL * top, (
        f"graph replays differ from eager by {diff:.3e} (max |value| {top})")
    out["executor"] = dict(launches=g_counts, captures=runner.captures,
                           keys=len(runner.graphs),
                           pool_bytes=runner.pool_bytes(), max_diff=diff,
                           max_value=top)
    log(f"executor sequence: launches {g_counts} with graphs and eagerly; "
        f"max |graph - eager| {diff:.3e} (bitwise: {diff == 0}) of max "
        f"|value| {top:.3e}; {runner.captures}, graph pool "
        f"{runner.pool_bytes() / 2**20:.1f} MiB over {len(runner.graphs)} keys")


# --- phase 5c: the H100 cost model ---------------------------------------------------

COST_LENS = (1024, 4096, 16384)


def costmodel_phase(torch, results):
    """``hardware.measure`` at full width on three prefix lengths (the
    serve path's graphs, counters zeroed just before and read just
    after: ``pre_infer`` and ``rank_full`` launch ``hstu_attn``,
    ``rank_cached`` and ``rank_full`` ``prefix_rank_attn``), the fitted
    H100 ``HardwareModel`` with each point's measured and predicted ms,
    and one baseline and one relay simulator point priced by it."""
    from repro_torch.benchmarks import hardware
    from repro_torch.benchmarks.capacity import HSTU, run_point
    from repro_torch.core import graphs
    from repro_torch.core.costmodel import GRCostModel

    t0 = time.perf_counter()
    graphs.write_counters({n: 0 for n in graphs.COUNTERS})
    measured = hardware.measure("cuda", smoke=False, lens=COST_LENS)
    torch.cuda.synchronize()
    counts = graphs.read_counters()
    for n in ("hstu_attn", "prefix_rank_attn"):
        assert counts[n] > 0, f"costmodel: {n} never launched"
        results[n]["launches"] += counts[n]
    tab = hardware.table(measured)
    hw = tab["hardware"]
    assert all(math.isfinite(r[k]) and r[k] > 0 for r in tab["fit"]
               for k in ("ms", "pred_ms")), tab["fit"]
    assert math.isfinite(hw["eff_flops"]) and hw["eff_flops"] > 0, hw
    assert math.isfinite(hw["h2d_bw"]) and hw["h2d_bw"] > 0, hw
    path = os.path.join(ROOT, "chiprun_out", "h100_hardware.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(tab, f, indent=1, sort_keys=True)
    cost = GRCostModel(HSTU, hardware.load(path))
    p99 = {}
    for mode in ("baseline", "relay"):
        s = run_point(mode, 2048, 60, cost=cost, dur=4.0)
        assert s["n"] > 0 and math.isfinite(s["p99_ms"]), (mode, s)
        p99[mode] = s["p99_ms"]
    line = {"eff_flops": hw["eff_flops"], "h2d_bw": hw["h2d_bw"],
            "points": [{k: r[k] for k in ("op", "L", "ms", "pred_ms",
                                            "rel_err")} for r in tab["fit"]],
            "h2d": tab["h2d"], "launches": {
                n: counts[n] for n in ("hstu_attn", "prefix_rank_attn")},
            "sim_p99_ms": p99, "seconds": time.perf_counter() - t0}
    print(json.dumps({"costmodel": line}), flush=True)


# --- phase 6: the Zamba2 hybrid serve path -----------------------------------------


def _ssd_inputs(torch, gen, B, nc, Q, H=64, P=64, N=64):
    """The SSD stages' inputs as mamba2_forward hands them over from the
    bf16 model: x, B, C cast to contiguous float32, dt = softplus(.),
    cum the cumulative log-decay dt * A (A = -exp(A_log) < 0)."""
    dev = torch.device("cuda")
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    xc = randn(B, nc, Q, H, P)
    Bc, Cc = randn(B, nc, Q, N), randn(B, nc, Q, N)
    dtc = torch.nn.functional.softplus(randn(B, nc, Q, H))
    A = -torch.exp(0.5 * randn(H))
    cum = torch.cumsum(dtc * A, dim=2)
    return Cc, Bc, xc, cum, dtc


def ssd_f64_accuracy(torch, results, Cc, Bc, xc, cum, dtc):
    """ssd_chunk_intra at the prefill shape against float64, within
    F64_REL of the largest |out|, at the path's decay and at a steep one
    (cum = cumsum(-20 dt): the masked exp(cum[q] - cum[t]) overflows);
    and proof that the limit fails single-pass TF32: the float64 version
    with C, B, x and M rounded to TF32 misses it."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as sk

    for label, cum in (("path", cum), ("steep", torch.cumsum(-20 * dtc, 2))):
        got = sk.ssd_chunk_intra(Cc, Bc, xc, cum, dtc)
        assert torch.isfinite(got).all(), f"ssd_chunk_intra {label}: non-finite"
        want = ref.ssd_chunk_intra_f64(Cc, Bc, xc, cum, dtc)
        top = want.abs().max().item()
        err = (got.double() - want).abs().max().item() / top
        tf32 = (ref.ssd_chunk_intra_f64(Cc, Bc, xc, cum, dtc, tf32=True)
                - want).abs().max().item() / top
        assert err <= F64_REL, (
            f"ssd_chunk_intra {label}: |kernel - float64| {err:.2e} of max "
            f"|out| over {F64_REL}")
        assert tf32 > F64_REL, (
            f"ssd_chunk_intra {label}: TF32 errs {tf32:.2e}, inside the limit")
        results["ssd_chunk_intra"].setdefault("f64_rel", {})[label] = dict(
            kernel=err, tf32=tf32)
        log(f"ssd_chunk_intra {label} decay vs float64: kernel {err:.2e}, "
            f"single-pass TF32 {tf32:.2e} of max |out| (limit {F64_REL})")


def _check(results, name, got, want, atol=TOL, rtol=TOL):
    """``got`` within ``atol + rtol |want|`` of ``want`` everywhere, a
    limit that an all-zero output fails; keeps the kernel's worst error
    and the least share of outputs an all-zero kernel fails."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    lim = atol + rtol * want.abs()
    assert bool(got.isfinite().all()), f"{name}: non-finite output"
    over = (want.abs() > lim).float().mean().item()
    assert over > 0, (
        f"{name}: the limit {atol} + {rtol}|plain| would pass all zeros")
    results[name]["zero_fails"] = min(results[name].get("zero_fails", 1.0),
                                      over)
    assert bool((err <= lim).all()), (
        f"{name}: |kernel - plain| {err.max().item():.3e} over "
        f"{atol} + {rtol}|plain|")
    e = err.max().item()
    results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)
    return e


def _record(torch, results, name, shape, e, fn, plain, flops, nbytes,
            library=None, tf32=False):
    """Time a kernel at one shape: kernel and library call in turns (K L
    L K, twice), the median of each (the library's time moves between
    calls, so the two are compared only within one); then the card's
    time per launch by CUDA-graph replay, the plain twin per call, and
    the bounds (for a 3xTF32 kernel that one too)."""
    runs = {"kernel": [], "library": []}
    order = ("kernel", "library", "library", "kernel") * 2
    for who in order:
        f = fn if who == "kernel" else library
        if f is not None:
            runs[who].append(_time_ms(torch, f))
    ms = statistics.median(runs["kernel"])
    lib_ms = statistics.median(runs["library"]) if runs["library"] else None
    graph_ms = _graph_ms(torch, fn)
    plain_ms = _time_ms(torch, plain, 5)
    bound_ms, by = _bound(flops, nbytes)
    tf32_ms = _bound_tf32(flops, nbytes) if tf32 else None
    results[name]["shapes"].append(dict(
        shape, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
        bound_tf32_ms=tf32_ms, max_abs_err=e, runs=runs))
    log(f"{name} {shape}: err {e:.2e} kernel {ms:.4f} ms (graph "
        f"{graph_ms:.4f}) plain {plain_ms:.4f} ms library {lib_ms} ms "
        f"bound {bound_ms:.4f} ms ({by}), 3xTF32 {tf32_ms}; turns {runs}")


def hybrid_kernel_checks(torch, results):
    import functools

    import torch.nn.functional as F
    from repro_torch.kernels import decode_attn as dk
    from repro_torch.kernels import ssd_chunk as sk

    gen = torch.Generator(device="cuda").manual_seed(1)
    check = functools.partial(_check, results)
    record = functools.partial(_record, torch, results)

    # SSD stages: the prefill's shape (64 chunks of 128, H = P = N = 64)
    # and one ragged chunk (Q = L = 100 < 128)
    for B, nc, Q in ((HYB_B, HYB_S // 128, 128), (HYB_B, 1, 100)):
        Cc, Bc, xc, cum, dtc = _ssd_inputs(torch, gen, B, nc, Q)
        H, P, N = xc.shape[3], xc.shape[4], Bc.shape[3]
        main = (B, nc * Q) == (HYB_B, HYB_S)
        y = sk.ssd_chunk_intra(Cc, Bc, xc, cum, dtc)
        e = check("ssd_chunk_intra", y,
                  sk.ssd_chunk_intra_ref(Cc, Bc, xc, cum, dtc))
        # bitwise: two calls, and each row of the batch alone
        assert torch.equal(sk.ssd_chunk_intra(Cc, Bc, xc, cum, dtc), y), \
            "ssd_chunk_intra: two calls differ"
        for b in range(B):
            s = slice(b, b + 1)
            one = sk.ssd_chunk_intra(Cc[s], Bc[s], xc[s], cum[s], dtc[s])
            assert torch.equal(one[0], y[b]), \
                "ssd_chunk_intra: batch-dependent row"
        if main:
            ssd_f64_accuracy(torch, results, Cc, Bc, xc, cum, dtc)
        # the work the function needs: C B^T once per chunk (it does not
        # depend on the head), the causal half of M x per head, and ~4
        # operations per kept entry of M; x, B, C, cum, dt in, y out
        kept = Q * (Q + 1) // 2
        flops = B * nc * (2 * Q * Q * N + H * kept * (2 * P + 4))
        nbytes = 4 * (2 * B * nc * Q * N + 2 * B * nc * Q * H * P
                      + 2 * B * nc * Q * H)
        record("ssd_chunk_intra", dict(B=B, L=nc * Q, Q=Q, H=H, P=P, N=N,
                                       main=main), e,
               lambda: sk.ssd_chunk_intra(Cc, Bc, xc, cum, dtc),
               lambda: sk.ssd_chunk_intra_ref(Cc, Bc, xc, cum, dtc),
               flops, nbytes, tf32=True)
        got = sk.ssd_chunk_state(Bc, xc, cum, dtc)
        e = check("ssd_chunk_state", got,
                  sk.ssd_chunk_state_ref(Bc, xc, cum, dtc))
        assert torch.equal(sk.ssd_chunk_state(Bc, xc, cum, dtc), got), \
            "ssd_chunk_state: two calls differ"
        w = torch.exp(cum[:, :, -1:, :] - cum) * dtc
        flops = B * nc * H * (2 * Q * N * P + 3 * Q)
        nbytes = 4 * (B * nc * Q * N + B * nc * Q * H * P + 2 * B * nc * Q * H
                      + B * nc * H * N * P)
        record("ssd_chunk_state", dict(B=B, L=nc * Q, Q=Q, H=H, P=P, N=N,
                                       main=main), e,
               lambda: sk.ssd_chunk_state(Bc, xc, cum, dtc),
               lambda: sk.ssd_chunk_state_ref(Bc, xc, cum, dtc),
               flops, nbytes,
               library=lambda: torch.einsum("bcqn,bcqh,bcqhp->bchnp",
                                            Bc, w, xc))

    # decode: the path's ring (S = 8192 after prefill, KV = H = 32, bf16,
    # one section of the stacked cache), rings no 64-key tile divides,
    # and GQA with 8 and 1 kv heads; float32 at the path's shape too
    H, D = 32, 64
    for S, KV, dtype in ((HYB_S, 32, torch.bfloat16), (HYB_S, 32, torch.float32),
                         (HYB_S + 37, 32, torch.bfloat16), (1000, 8, torch.bfloat16),
                         (777, 1, torch.float32), (HYB_S, 8, torch.bfloat16)):
        q = torch.randn((HYB_B, H, D), generator=gen, device="cuda").to(dtype)
        kc = torch.randn((6, HYB_B, S, KV, D), generator=gen,
                         device="cuda").to(dtype)
        vc = torch.randn((6, HYB_B, S, KV, D), generator=gen,
                         device="cuda").to(dtype)
        k, v = kc[2], vc[2]
        want = dk.decode_attn_plain(q, k, v)
        atol, rtol = (TOL, TOL) if dtype == torch.float32 else \
            (BF16_REL * want.float().abs().max().item(), 0.0)
        got = dk.decode_attn(q, k, v)
        e = check("decode_attn", got, want, atol, rtol)
        assert torch.equal(dk.decode_attn(q, k, v), got), \
            "decode_attn: two calls differ"
        esz = k.element_size()
        flops = 4 * HYB_B * H * S * D + 5 * HYB_B * H * S
        nbytes = esz * (2 * HYB_B * S * KV * D + 2 * HYB_B * H * D)
        main = (S, KV, dtype) == (HYB_S, 32, torch.bfloat16)
        record("decode_attn", dict(B=HYB_B, S=S, H=H, KV=KV, D=D,
                                   dtype=str(dtype), atol=atol, rtol=rtol,
                                   main=main), e,
               lambda: dk.decode_attn(q, k, v),
               lambda: dk.decode_attn_plain(q, k, v), flops, nbytes,
               library=lambda: F.scaled_dot_product_attention(
                   q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                   enable_gqa=True))
    log("hybrid kernels agree with their plain twins; least share of outputs "
        "an all-zero kernel would fail: " + ", ".join(
            f"{n} {results[n]['zero_fails']:.3f}" for n in
            ("decode_attn", "ssd_chunk_intra", "ssd_chunk_state")))


def hybrid_phase(torch, results):
    import dataclasses

    import numpy as np
    from repro_torch.kernels import decode_attn as dk
    from repro_torch.kernels import ssd_chunk as sk
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model, get_config

    hybrid_kernel_checks(torch, results)

    def live_lora(model, seed):
        g = torch.Generator().manual_seed(seed)
        lb = model.shared_attn.lora_b
        with torch.no_grad():
            lb.copy_(torch.randn(lb.shape, generator=g)
                     / math.sqrt(lb.shape[1]))
        return model

    cfg = get_config("zamba2_1p2b")
    t0 = time.perf_counter()
    model = live_lora(build_model(cfg, device="cuda").init(
        torch.Generator().manual_seed(0)), 1)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"zamba2_1p2b: {n_params / 1e9:.3f} B parameters ({cfg.dtype}), "
        f"built in {time.perf_counter() - t0:.1f} s")
    prefill, serve_step = make_prefill_step(model), make_serve_step(model)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (HYB_B, HYB_S)),
                              device="cuda")
    prefill({"tokens": prompts})       # warm-up at the timed shape (cuBLAS,
                                       # allocator, first-shape costs)
    torch.cuda.synchronize()

    counters = lambda: {"ssd_chunk_intra": sk.launches_intra,
                        "ssd_chunk_state": sk.launches_state,
                        "decode_attn": dk.launches}

    def zero():
        sk.launches_intra = sk.launches_state = dk.launches = 0

    zero()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = prefill({"tokens": prompts})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    c_pre = counters()
    log(f"prefill {HYB_B} x {HYB_S}: {prefill_ms:.1f} ms, launches {c_pre}, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    assert c_pre == {"ssd_chunk_intra": cfg.n_layers,
                     "ssd_chunk_state": cfg.n_layers, "decode_attn": 0}, c_pre
    assert logits.shape == (HYB_B, 1, cfg.vocab_padded), logits.shape
    assert torch.isfinite(logits).all(), "prefill: non-finite logits"
    assert tuple(cache["a"][0].shape) == (model.n_sections, HYB_B, HYB_S,
                                          cfg.n_kv_heads, cfg.head_dim)

    # decode: the main path replays a CUDA graph per (batch, cache) key
    # (make_serve_step's default); graphs and eager then in turns from
    # copies of the same post-prefill cache, with identical greedy tokens
    clone = lambda c: {"m": {k: tuple(t.clone() for t in v)
                             for k, v in c["m"].items()},
                       "a": tuple(t.clone() for t in c["a"])}
    base = clone(cache)
    eager_step = make_serve_step(model, graphs=False)
    tok0 = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
    pos = torch.full((HYB_B,), HYB_S, device="cuda")

    def decode(step, c, counted=False):
        """HYB_STEPS greedy steps: (ms of the first step, ms per later
        step, ms per step over all, tokens, last logits)."""
        tok, out = tok0, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(HYB_STEPS):
            before = dk.launches
            logits, c = step(c, {"token": tok, "pos": pos + i})
            if counted:
                assert dk.launches - before == model.n_sections, (i, dk.launches)
            tok = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
            out.append(tok)
            if i == 0:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return ((t1 - t0) * 1e3, (t2 - t1) * 1e3 / (HYB_STEPS - 1),
                (t2 - t0) * 1e3 / HYB_STEPS, torch.cat(out, 1), logits)

    zero()
    first_ms, rest_ms, decode_ms, gen_toks, logits = decode(serve_step, cache,
                                                            counted=True)
    c_dec = counters()
    log(f"decode {HYB_STEPS} steps (graphs): {decode_ms:.2f} ms/step "
        f"(first {first_ms:.2f}, later {rest_ms:.4f}), "
        f"{HYB_B * 1e3 / decode_ms:.1f} tokens/s, launches {c_dec}")
    assert c_dec == {"ssd_chunk_intra": 0, "ssd_chunk_state": 0,
                     "decode_attn": model.n_sections * HYB_STEPS}, c_dec
    assert torch.isfinite(logits).all(), "decode: non-finite logits"
    assert ((gen_toks >= 0) & (gen_toks < cfg.vocab)).all()
    for name in c_pre:
        results[name]["launches"] += c_pre[name] + c_dec[name]
    turns = {"graphs": [(first_ms, rest_ms, decode_ms)], "eager": []}
    for who in ("eager", "eager", "graphs"):
        f, r, d, toks, _ = decode(eager_step if who == "eager" else serve_step,
                                  clone(base))
        assert torch.equal(toks, gen_toks), f"decode ({who}): other tokens"
        turns[who].append((f, r, d))
    graph_pool = serve_step.runner.pool_bytes()
    log(f"decode ms per step (first, later, all), graphs {turns['graphs']}, "
        f"eager {turns['eager']}; greedy tokens identical; graph pool "
        f"{graph_pool / 2**20:.1f} MiB over "
        f"{len(serve_step.runner.graphs)} cache keys")

    prof_pre = profile_fn(torch, f"prefill {HYB_B}x{HYB_S}",
                          lambda: prefill({"tokens": prompts}), 1)
    ssd = {re.search(r"ssd_\w+", k).group(0): v
           for k, v in prof_pre["kernels"].items() if "ssd_" in k}
    ssd_ms = sum(ssd.values())
    log(f"prefill {HYB_B}x{HYB_S}: wall {prof_pre['wall_ms']:.4f} ms, device "
        f"busy {prof_pre['busy_ms']:.4f} ms, SSD kernels {ssd_ms:.4f} ms "
        f"({ssd_ms / prof_pre['wall_ms']:.3f} of the wall): " + ", ".join(
            f"{k} {v:.4f}" for k, v in ssd.items()))
    prof_pre["ssd_ms"] = ssd_ms
    prof_dec = {}
    for who, step in (("graphs", serve_step), ("eager", eager_step)):
        probe = clone(base)
        batch = {"token": tok0, "pos": pos}
        step(probe, batch)                  # capture / warm
        prof_dec[who] = profile_fn(torch, f"decode step ({who})",
                                   lambda: step(probe, batch), 5)
    results["_hybrid"] = dict(
        config="zamba2_1p2b", params=n_params, batch=HYB_B, prompt=HYB_S,
        steps=HYB_STEPS, prefill_ms=prefill_ms,
        prefill_tok_s=HYB_B * HYB_S * 1e3 / prefill_ms,
        decode_ms_per_step=decode_ms, decode_tok_s=HYB_B * 1e3 / decode_ms,
        decode_turns=turns, decode_graph_pool_bytes=graph_pool,
        launches_prefill=c_pre, launches_decode=c_dec,
        profile_prefill=prof_pre, profile_decode=prof_dec,
        generated=gen_toks.tolist())

    # card vs CPU: float32, full width, 7 layers (one section + 1 tail)
    cfg32 = dataclasses.replace(cfg, n_layers=7, dtype="float32")
    cpu = live_lora(build_model(cfg32, device="cpu").init(
        torch.Generator().manual_seed(2)), 3)
    gpu = build_model(cfg32, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (HYB_B, HYB_CPU_S)))
    worst = 0.0

    def close(step, a, b):
        nonlocal worst
        scale = max(b.abs().max().item(), 1.0)
        d = (a.cpu() - b).abs().max().item() / scale
        worst = max(worst, d)
        assert d <= HYB_REL, f"card vs CPU at {step}: {d:.2e} of max |logit|"

    lg, cg = make_prefill_step(gpu)({"tokens": toks.cuda()})
    lc, cc = make_prefill_step(cpu)({"tokens": toks})
    close("prefill", lg, lc)
    sg, sc = make_serve_step(gpu), make_serve_step(cpu)
    for i in range(HYB_CPU_STEPS):
        tok = lc[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
        pos = torch.full((HYB_B,), HYB_CPU_S + i)
        lg, cg = sg(cg, {"token": tok.cuda(), "pos": pos.cuda()})
        lc, cc = sc(cc, {"token": tok, "pos": pos})
        close(f"decode {i}", lg, lc)
    log(f"card vs CPU (float32, 7 layers, {HYB_B}x{HYB_CPU_S} + "
        f"{HYB_CPU_STEPS} steps): max diff {worst:.2e} of max |logit| "
        f"(limit {HYB_REL})")
    results["_hybrid"]["card_vs_cpu_rel"] = worst


# --- phase 7: HSTU training and decode -----------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 4096, 20   # train_4k's length, B of one card
TRAIN_GRAD_REL = 1e-5    # HSTUAttnFunction grads vs float64, of the largest |g|
TRAIN_CPU_LOSS_REL = 1e-5      # card vs CPU float64: the loss, relative
TRAIN_CPU_GRAD_REL = 1e-4      # ... each leaf's gradient, of its largest |g|
TRAIN_CPU_B, TRAIN_CPU_S, TRAIN_CPU_L = 2, 1024, 2
TRAIN_LOSS_DROP = 0.5    # last-5 mean below step 0's by at least this (nats)
TRAIN_PEAK_GIB = 12.0    # max_memory_allocated of the 20 steps
CKPT_REL = 1e-6          # restored run's next losses vs the uninterrupted run's
DEC_B, DEC_P, DEC_STEPS = 2, 2048, 4
DEC_REL = 1e-4           # card vs CPU decode logits, of the largest |logit|
TRAIN_PARTS = ("unembed/CE", "attention kernel", "attention backward",
               "other GEMMs", "optimizer", "embedding", "other")


def _train_part(evt, kernel, vp):
    """The part of a train step that ``kernel`` (launched under CPU op
    ``evt``) belongs to, from the op's ancestors: the ``adamw`` and
    ``hstu_attn_backward`` ranges, the rank kernel by name, the token
    gather and its backward, ops on a vocab-wide tensor (the unembed
    product and the CE, forward, recompute and backward), GEMMs."""
    chain = []
    while evt is not None:
        chain.append(evt)
        evt = evt.cpu_parent
    names = [e.name for e in chain]
    if "adamw" in names:
        return "optimizer"
    if "hstu_attn_backward" in names:
        return "attention backward"
    if "hstu_rank" in kernel.name:
        return "attention kernel"
    if any("IndexBackward" in n or "embedding" in n or n == "aten::index"
           for n in names):
        return "embedding"
    if any(vp in (s if isinstance(s, (list, tuple)) else ())
           for e in chain for s in (e.input_shapes or ())):
        return "unembed/CE"
    if any(w in kernel.name.lower() for w in ("gemm", "xmma", "cutlass")) or \
            any(n in ("aten::mm", "aten::bmm", "aten::addmm", "aten::matmul")
                for n in names):
        return "other GEMMs"
    return "other"


def train_profile(torch, fn, vp):
    """One train step under torch.profiler: device ms by part
    (``_train_part``), wall by CUDA events, and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    parts = dict.fromkeys(TRAIN_PARTS, 0.0)
    attributed, device = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            for k in e.kernels:
                parts[_train_part(e, k, vp)] += k.duration / 1e3
                attributed[k.name] = attributed.get(k.name, 0.0) \
                    + k.duration / 1e3
        elif e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            # device activity; a record_function range's device span
            # (gpu_user_annotation) is not
            device[e.name] = device.get(e.name, 0.0) \
                + (e.time_range.end - e.time_range.start) / 1e3
    busy = sum(device.values())
    parts["unattributed"] = busy - sum(attributed.values())
    gaps = sorted(((device[n] - attributed.get(n, 0.0), n) for n in device),
                  reverse=True)[:5]
    return dict(wall_ms=wall, busy_ms=busy,
                idle_share=max(0.0, 1 - busy / wall), parts=parts,
                unattributed_top=[(n[:80], ms) for ms, n in gaps if ms > 0])


def attn_grad_checks(torch, results):
    """``HSTUAttnFunction`` (the kernel forward, the float32 backward) on
    the card against float64 autograd over the plain twin, within
    TRAIN_GRAD_REL of each gradient's largest |g|; then the kernel at the
    train shape (B 8 x S 4096) against its twin, timed beside its bounds,
    and the plain backward timed beside its own.  These launches are
    comparisons, outside the main path's counts."""
    from repro_torch.kernels import hstu_attn as hk
    from repro_torch.kernels import ref
    out = results["_train"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {}
    for S in (1, 17, 128, 1000, 4096):
        for Dh in (32, 64):
            q, k, v, dout = (torch.randn(2, H, S, Dh, generator=gen,
                                         device="cuda") for _ in range(4))
            f32 = [t.clone().requires_grad_(True) for t in (q, k, v)]
            got = hk.hstu_attn(*f32)
            assert type(got.grad_fn).__name__.startswith("HSTUAttnFunction")
            got.backward(dout)
            f64 = [t.double().requires_grad_(True) for t in (q, k, v)]
            hk.hstu_attn_plain(*f64).backward(dout.double())
            for name, a, b in zip("qkv", f32, f64):
                rel = ((a.grad.double() - b.grad).abs().max()
                       / b.grad.abs().max()).item()
                assert rel <= TRAIN_GRAD_REL, (
                    f"d{name} S={S} D={Dh}: {rel:.2e} of the largest |g| "
                    f"(limit {TRAIN_GRAD_REL})")
                worst[f"d{name}"] = max(worst.get(f"d{name}", 0.0), rel)
            del f32, f64, got
    out["attn_grad_rel"] = worst
    log(f"HSTUAttnFunction grads vs float64 (S 1..4096, D 32 / 64): worst "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f" of the largest |g| (limit {TRAIN_GRAD_REL})")

    B, S = TRAIN_B, TRAIN_S
    q, k, v, dout = (torch.randn(B, H, S, D, generator=gen, device="cuda")
                     for _ in range(4))
    got = hk.hstu_attn(q, k, v)
    want = hk.hstu_attn_plain(q, k, v)
    err = (got - want).abs()
    assert bool((err <= TOL + TOL * want.abs()).all()), "hstu_attn at 8 x 4096"
    e = err.max().item()
    results["hstu_attn"]["max_abs_err"] = max(
        results["hstu_attn"]["max_abs_err"], e)
    # and against float64, a batch row at a time ((S, S) float64 scores)
    causal = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    diff = top = 0.0
    for b in range(B):
        ref64 = ref.silu_attn_f64(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal,
                                  n_total=S)
        diff = max(diff, (got[b:b + 1].double() - ref64).abs().max().item())
        top = max(top, ref64.abs().max().item())
    f64 = diff / top
    assert f64 <= F64_REL, (
        f"hstu_attn at {B} x {S}: |kernel - float64| {f64:.2e} of max |out| "
        f"over {F64_REL}")
    results["hstu_attn"].setdefault("f64_rel", {})[f"train {B}x{S}"] = dict(
        kernel=f64)
    del got, want, err, causal, ref64
    pairs = B * H * S * (S + 1) // 2
    t = _rank_times(torch, lambda: hk.hstu_attn(q, k, v),
                    lambda: hk.hstu_attn_plain(q, k, v), 4 * D * pairs,
                    4 * 4 * B * H * S * D)
    results["hstu_attn"]["shapes"].append(dict(B=B, S=S, main=False,
                                               train=True, max_abs_err=e, **t))
    # the backward recomputes s and does four more products, ten
    # multiply-adds a kept pair per head-dim element; reads q, k, v, dout,
    # writes dq, dk, dv
    bwd_ms = _time_ms(torch, lambda: hk.hstu_attn_backward(q, k, v, dout, S),
                      iters=3)
    bwd_bound, bwd_by = _bound(10 * D * pairs, 7 * 4 * B * H * S * D)
    out["attn_train_shape"] = dict(B=B, S=S, fwd=t, bwd_ms=bwd_ms,
                                   bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_by)
    log(f"hstu_attn B={B} S={S}: err {e:.2e}, {f64:.2e} of max |out| vs "
        f"float64 (limit {F64_REL}); kernel {t['ms']:.4f} ms (graph "
        f"{t['graph_ms']:.4f}) plain {t['plain_ms']:.4f} ms bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}), 3xTF32 "
        f"{t['bound_tf32_ms']:.4f} ms; plain backward {bwd_ms:.4f} ms, bound "
        f"{bwd_bound:.4f} ms ({bwd_by})")


def train_card_vs_cpu(torch, out):
    """Loss and every gradient at full width, 2 layers, B 2 x S 1024: the
    card (float32) against the port on the CPU in float64."""
    import dataclasses

    from repro_torch.data.synthetic import UserBehaviorStore, WorkloadConfig
    from repro_torch.models import build_model, get_config

    cfg = dataclasses.replace(get_config("hstu-gr"), n_layers=TRAIN_CPU_L)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    cpu.double()
    batch = next(UserBehaviorStore(WorkloadConfig(vocab=cfg.vocab))
                 .train_batches(TRAIN_CPU_B, TRAIN_CPU_S, seed=1))
    t0 = time.perf_counter()
    losses = {}
    for name, m in (("card", gpu), ("cpu", cpu)):
        m.requires_grad_(True)
        loss, _ = m.loss(batch)
        loss.backward()
        losses[name] = loss.item()
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    assert rel <= TRAIN_CPU_LOSS_REL, (
        f"card vs CPU loss {losses}: {rel:.2e} relative")
    grads = {}
    own = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        want = own[name].grad
        if want is None:
            assert p.grad is None, name
            continue
        grads[name] = ((p.grad.cpu().double() - want).abs().max()
                       / want.abs().max()).item()
        assert grads[name] <= TRAIN_CPU_GRAD_REL, (
            f"card vs CPU d{name}: {grads[name]:.2e} of the largest |g|")
    out["card_vs_cpu"] = dict(loss=losses, loss_rel=rel, grad_rel=grads)
    log(f"train card vs CPU float64 (full width, {TRAIN_CPU_L} layers, "
        f"{TRAIN_CPU_B} x {TRAIN_CPU_S}, {time.perf_counter() - t0:.1f} s): "
        f"loss {losses['card']:.6f} ({rel:.2e} relative), worst gradient "
        f"{max(grads.values()):.2e} of the largest |g| (limits "
        f"{TRAIN_CPU_LOSS_REL}, {TRAIN_CPU_GRAD_REL})")


def decode_kernel_check(torch, results):
    """``prefix_rank_attn`` at HSTU decode's own shape (one query, n_incr
    1, no items, a DEC_P-token psi) against its plain twin within TOL and
    float64 within F64_REL of the largest |out|.  These launches are
    comparisons, outside the main path's counts.  Returns the float64
    error."""
    from repro_torch.kernels import prefix_rank_attn as rk
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(6)
    q, kn, vn = (torch.randn(DEC_B, H, 1, D, generator=gen, device="cuda")
                 for _ in range(3))
    kp, vp = (torch.randn(DEC_B, H, DEC_P, D, generator=gen, device="cuda")
              for _ in range(2))
    got = rk.prefix_rank_attn_split(q, kp, vp, kn, vn, n_incr=1)
    k, v = torch.cat([kp, kn], 2), torch.cat([vp, vn], 2)
    plain = rk.prefix_rank_attn_plain(q, k, v, n_prefix=DEC_P, n_incr=1)
    err = (got - plain).abs()
    assert torch.isfinite(got).all(), "prefix_rank_attn at decode: non-finite"
    assert bool((err <= TOL + TOL * plain.abs()).all()), (
        f"prefix_rank_attn at decode: |kernel - plain| "
        f"{err.max().item():.3e} over {TOL} + {TOL}|plain|")
    e = err.max().item()
    results["prefix_rank_attn"]["max_abs_err"] = max(
        results["prefix_rank_attn"]["max_abs_err"], e)
    want = ref.silu_attn_f64(q, k, v, ref.rank_mask_ref(DEC_P, 1, 0,
                                                        device="cuda"),
                             n_total=DEC_P + 1)
    f64 = ((got.double() - want).abs().max() / want.abs().max()).item()
    assert f64 <= F64_REL, (
        f"prefix_rank_attn at decode: |kernel - float64| {f64:.2e} of max "
        f"|out| over {F64_REL}")
    results["prefix_rank_attn"].setdefault("f64_rel", {})[
        f"decode {DEC_B}x1 over {DEC_P}"] = dict(kernel=f64)
    log(f"prefix_rank_attn at decode ({DEC_B} x 1 query over {DEC_P}): "
        f"vs plain {e:.2e}, vs float64 {f64:.2e} of max |out| (limits "
        f"{TOL}, {F64_REL})")
    return f64


def train_phase(torch, results):
    """HSTU training and decode at full width: ``HSTUAttnFunction``
    against float64, card vs CPU, the full run (hstu-gr, 8 layers, B 8 x
    S 4096, 20 AdamW steps, the launcher's schedule; ``hstu_attn``
    counted), a profiled step, a checkpoint round trip, then
    ``decode_step`` over a 2048-token psi (``prefix_rank_attn`` counted,
    graphs against eager, card against CPU)."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.core.graphs import COUNTERS, read_counters, write_counters
    from repro_torch.data.synthetic import UserBehaviorStore, WorkloadConfig
    from repro_torch.launch.steps import make_serve_step, make_train_step
    from repro_torch.models import build_model, get_config
    from repro_torch.models.convert import param_tree
    from repro_torch.training import checkpoint
    from repro_torch.training import optimizer as opt
    from repro_torch.tree import leaves

    out = results.setdefault("_train", {})
    attn_grad_checks(torch, results)
    train_card_vs_cpu(torch, out)

    # the full run: every parameter trained, counters zeroed just before
    cfg = get_config("hstu-gr")
    adamw = opt.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=TRAIN_STEPS)
    model = build_model(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(model, adamw)
    state = opt.init_state(step.params)
    gen = UserBehaviorStore(WorkloadConfig(vocab=cfg.vocab)).train_batches(
        TRAIN_B, TRAIN_S, seed=0)
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in
                next(gen).items()} for _ in range(TRAIN_STEPS + 3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    write_counters(dict.fromkeys(COUNTERS, 0))
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(TRAIN_STEPS)]
    metrics = []
    t0 = time.perf_counter()
    for (a, b), batch in zip(events, batches):
        a.record()
        metrics.append(step(state, batch))
        b.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counters()
    launches = counts.pop("hstu_attn")
    assert not any(counts.values()), f"train launched other kernels: {counts}"
    peak = torch.cuda.max_memory_allocated()
    ms = [a.elapsed_time(b) for a, b in events]
    losses = [m["loss"].item() for m in metrics]
    gnorms = [m["grad_norm"].item() for m in metrics]
    med = statistics.median(ms)
    # the rate over the whole window (every step's events), so a slow step
    # shows in it; the median ms/step beside it
    tok_s = TRAIN_STEPS * TRAIN_B * TRAIN_S * 1e3 / sum(ms)
    log(f"train hstu-gr ({n_params / 1e6:.2f} M parameters, {cfg.n_layers} "
        f"layers), {TRAIN_B} x {TRAIN_S}, {TRAIN_STEPS} steps in {wall_s:.1f} "
        f"s: median {med:.2f} ms/step (first {ms[0]:.2f}, the {TRAIN_STEPS} "
        f"{sum(ms):.2f} ms), {tok_s:.0f} tokens/s over them, peak {peak / 2**30:.2f} GiB, hstu_attn launches "
        f"{launches}")
    log(f"train losses {[round(x, 4) for x in losses]}; grad norms "
        f"{[round(x, 3) for x in gnorms]}")
    assert all(math.isfinite(x) for x in losses + gnorms), "non-finite loss"
    assert statistics.mean(losses[-5:]) < losses[0] - TRAIN_LOSS_DROP, (
        f"the loss did not fall by {TRAIN_LOSS_DROP}: {losses}")
    assert peak <= TRAIN_PEAK_GIB * 2**30, f"peak {peak / 2**30:.2f} GiB"
    assert launches == 2 * cfg.n_layers * TRAIN_STEPS, (
        f"hstu_attn launched {launches} times in {TRAIN_STEPS} steps")
    results["hstu_attn"]["launches"] += launches
    prof = train_profile(torch, lambda: step(state, batches[TRAIN_STEPS]),
                         cfg.vocab_padded)
    log(f"train step profile: wall {prof['wall_ms']:.2f} ms, device busy "
        f"{prof['busy_ms']:.2f} ms, idle share {prof['idle_share']:.3f} "
        f"(both under the profiler, whose host cost stretches the wall); "
        + ", ".join(f"{k} {v:.2f}" for k, v in prof["parts"].items())
        + f"; unattributed by kernel {prof['unattributed_top']}")

    # checkpoint round trip: save, restore into a fresh model, bit for
    # bit; the next two steps' losses from both within CKPT_REL
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        path = os.path.join(tmp, "hstu")
        t1 = time.perf_counter()
        checkpoint.save(path, step.params, state, step=TRAIN_STEPS + 1)
        twin = build_model(cfg, device="cuda")
        tparams = param_tree(twin)
        got, saved = checkpoint.restore(
            path, {"params": tparams, "opt": opt.init_state(tparams)})
        ck_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp)
    assert saved == TRAIN_STEPS + 1
    for (a, b) in ((step.params, got["params"]), (state, got["opt"])):
        for x, y in zip(leaves(a), leaves(b)):
            assert x.dtype == y.dtype and torch.equal(x.detach().cpu(),
                                                      y.cpu()), "checkpoint"
    with torch.no_grad():
        for p, r in zip(leaves(tparams),
                        leaves(got["params"])):
            p.copy_(r)
    step2 = make_train_step(twin, adamw)
    state2 = got["opt"]
    pairs = []
    for batch in batches[TRAIN_STEPS + 1:]:
        a, b = step(state, batch)["loss"].item(), step2(state2, batch)["loss"].item()
        pairs.append((a, b))
        assert abs(a - b) <= CKPT_REL * abs(a), f"restored run: {a} vs {b}"
    log(f"checkpoint: saved and restored in {ck_s:.1f} s, bit for bit; next "
        f"losses uninterrupted / restored {pairs}")
    out["run"] = dict(config="hstu-gr", params=n_params, batch=TRAIN_B,
                      seq=TRAIN_S, steps=TRAIN_STEPS, ms_per_step=ms,
                      median_ms=med, tokens_per_s=tok_s, peak_bytes=peak,
                      losses=losses, grad_norms=gnorms, launches=launches,
                      profile=prof, checkpoint_s=ck_s, restored_losses=pairs)
    del model, twin, step, step2, state, state2, got, tparams, batches
    torch.cuda.empty_cache()

    # decode: one token per row over a 2048-token psi, per-row positions
    gpu = build_model(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    _, psi = gpu.prefill({"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (DEC_B, DEC_P)), device="cuda")})
    graphs, eager = make_serve_step(gpu), make_serve_step(gpu, graphs=False)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (DEC_STEPS, DEC_B, 1)),
                           device="cuda")
    pos = torch.tensor([DEC_P, DEC_P - 37], device="cuda")
    write_counters(dict.fromkeys(COUNTERS, 0))
    got = []
    for i in range(DEC_STEPS):
        logits, cache = graphs(psi, {"token": toks[i], "pos": pos})
        assert cache is psi
        got.append(logits)
    torch.cuda.synchronize()
    counts = read_counters()
    dec_launches = counts.pop("prefix_rank_attn")
    assert not any(counts.values()), f"decode launched other kernels: {counts}"
    assert dec_launches == cfg.n_layers * DEC_STEPS, dec_launches
    results["prefix_rank_attn"]["launches"] += dec_launches
    dec_f64 = decode_kernel_check(torch, results)
    worst = 0.0
    cpsi = tuple(t.cpu() for t in psi)
    for i in range(DEC_STEPS):
        batch = {"token": toks[i], "pos": pos}
        want = eager(psi, batch)[0]
        assert torch.equal(got[i], want), f"decode {i}: replay != eager"
        ref = cpu.decode_step(cpsi, {"token": toks[i].cpu(),
                                     "pos": pos.cpu()})[0]
        d = ((want.cpu() - ref).abs().max() / ref.abs().max()).item()
        assert d <= DEC_REL, f"decode {i}: card vs CPU {d:.2e} of max |logit|"
        worst = max(worst, d)
    batch = {"token": toks[0], "pos": pos}
    g_ms = _time_ms(torch, lambda: graphs(psi, batch))
    e_ms = _time_ms(torch, lambda: eager(psi, batch))
    out["decode"] = dict(batch=DEC_B, psi=DEC_P, steps=DEC_STEPS,
                         launches=dec_launches, kernel_f64_rel=dec_f64,
                         card_vs_cpu_rel=worst,
                         graph_ms=g_ms, eager_ms=e_ms)
    log(f"hstu decode B={DEC_B} over {DEC_P} tokens: {dec_launches} "
        f"prefix_rank_attn launches in {DEC_STEPS} graph steps, replay == "
        f"eager bit for bit, card vs CPU {worst:.2e} of max |logit| (limit "
        f"{DEC_REL}); {g_ms:.4f} ms a step with graphs, {e_ms:.4f} eager")


# --- phase 8: the decoder-only Transformer (dense, MoE, VLM) --------------------

LM_B = 2                                  # prompts
# (arch, layers kept (None: all), prompt tokens, decode steps)
LM_RUNS = (("qwen3_4b", None, 8192, 32),
           ("deepseek_moe_16b", 4, 2048, 32),
           ("internvl2_2b", None, 2048, 8))
LM_CPU_LAYERS, LM_CPU_S, LM_CPU_STEPS = 2, 256, 4   # card-vs-CPU check
LM_REL = 5e-4                   # card vs CPU, of the largest |logit|
# ... deepseek_moe_16b at the reference init: no qk-norm, and the init
# rule's fan-in for wq / wk is the head count, so its attention logits
# have a std of ~128: float32 reorderings reach its logits at ~5e-4 and
# flip one prefill token's top-6 at layer 1 (a router gap of ~1e-5);
# 9.9e-7 with wq / wk at fan-in d_model, checked at LM_REL beside it
LM_REL_INIT = 2e-3
# faults planted on the card at the reference init, each of which the
# LM_REL_INIT limit must catch: float32 products in TF32, and the shared
# experts' output dropped
LM_PLANTED = ("TF32 on", "shared experts dropped")
# bf16 decode vs float64, of the largest |out|: the output's rounding to
# bf16 (half an ulp, at most 2**-8 of the largest |out|) plus F64_REL
LM_F64_BF16 = 2 ** -8 + F64_REL
# decode_attn at the family's groups, D 128: (config, H, KV); G = H / KV
LM_GROUPS = (("qwen3_4b", 32, 8), ("yi_9b", 32, 4),
             ("starcoder2_7b real heads", 36, 4), ("starcoder2_15b", 48, 4),
             ("internvl2_2b", 16, 8), ("deepseek_moe_16b", 16, 16),
             ("dbrx_132b", 48, 8))
LM_RINGS = (4096, 8192)                   # the window; qwen3's prompt
LM_LONG = (8, 32768)                      # decode_32k-like: B, S


def _decode_check(torch, results, tag, q, k, v):
    """One ``decode_attn`` call held against its plain twin (f32 within
    TOL + TOL|plain|, bf16 within BF16_REL of the largest |plain|) and
    float64 (the twin on float64 inputs, one batch row at a time; f32
    within F64_REL, bf16 within LM_F64_BF16 of the largest |out|), and a
    second call bit for bit.  Returns (error record, atol, rtol, the
    float64 error)."""
    from repro_torch.kernels import decode_attn as dk

    got = dk.decode_attn(q, k, v)
    want = dk.decode_attn_plain(q, k, v)
    bf16 = q.dtype == torch.bfloat16
    atol, rtol = (BF16_REL * want.float().abs().max().item(), 0.0) \
        if bf16 else (TOL, TOL)
    e = _check(results, "decode_attn", got, want, atol, rtol)
    assert torch.equal(dk.decode_attn(q, k, v), got), \
        f"decode_attn {tag}: two calls differ"
    ref64 = torch.cat([dk.decode_attn_plain(*(t[b:b + 1].double()
                                               for t in (q, k, v)))
                       for b in range(q.shape[0])])
    rel = ((got.double() - ref64).abs().max() / ref64.abs().max()).item()
    lim = LM_F64_BF16 if bf16 else F64_REL
    assert rel <= lim, (f"decode_attn {tag}: |kernel - float64| {rel:.2e} "
                        f"of max |out| over {lim}")
    results["decode_attn"].setdefault("f64_rel", {})[tag] = rel
    return e, atol, rtol, rel


def lm_kernel_checks(torch, results):
    """``decode_attn`` at the Transformer family's GQA groups (G 1, 2, 4,
    6, 8, 9, 12), D 128, over rings of 4096 and 8192 slots (bf16 and
    float32), at each served run's own heads and ring (LM_RUNS: F + S
    slots, bf16), and a decode_32k-like case (qwen3's heads, B 8, S
    32768, bf16), each through ``_decode_check``; timed beside the byte
    bound and SDPA (``enable_gqa``).  Launches here are comparisons,
    outside the main path's counts."""
    import functools

    import torch.nn.functional as F
    from repro_torch.kernels import decode_attn as dk
    from repro_torch.models import get_config

    gen = torch.Generator(device="cuda").manual_seed(7)
    record = functools.partial(_record, torch, results)
    cases = [(name, H, KV, LM_B, S, dt) for name, H, KV in LM_GROUPS
             for S in LM_RINGS for dt in (torch.bfloat16, torch.float32)]
    for arch, _, S, _ in LM_RUNS:
        cfg = get_config(arch)
        H, KV, ring = cfg.n_heads, cfg.n_kv_heads, cfg.n_frontend_tokens + S
        if not any(c[1:5] == (H, KV, LM_B, ring) for c in cases):
            cases.append((f"{arch} served ring", H, KV, LM_B, ring,
                          torch.bfloat16))
    cases.append(("decode_32k (qwen3_4b)", 32, 8, *LM_LONG, torch.bfloat16))
    D = 128
    for name, H, KV, B, S, dtype in cases:
        q = torch.randn((B, H, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, S, KV, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, S, KV, D), generator=gen, device="cuda").to(dtype)
        tag = f"{name} G {H // KV} B {B} S {S} {str(dtype)[6:]}"
        e, atol, rtol, rel = _decode_check(torch, results, tag, q, k, v)
        esz = k.element_size()
        flops = 4 * B * H * S * D + 5 * B * H * S
        nbytes = esz * (2 * B * S * KV * D + 2 * B * H * D)
        record("decode_attn", dict(config=name, B=B, S=S, H=H, KV=KV, G=H // KV,
                                   D=D, dtype=str(dtype), atol=atol,
                                   rtol=rtol, f64_rel=rel, main=False), e,
               lambda: dk.decode_attn(q, k, v),
               lambda: dk.decode_attn_plain(q, k, v), flops, nbytes,
               library=lambda: F.scaled_dot_product_attention(
                   q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                   enable_gqa=True))
    torch.cuda.empty_cache()
    f64 = results["decode_attn"]["f64_rel"]
    log(f"decode_attn at G 1-12, D 128: agrees with its twin and float64 "
        f"(worst float64 error {max(f64.values()):.2e} of max |out|)")


def _kernel_classes(kernels):
    """A profile's device ms by kernel class: cuBLAS / CUTLASS products
    (GEMV and GEMM), ``decode_attn``, and the rest (elementwise, norms,
    casts, copies)."""
    out = {"GEMV/GEMM": 0.0, "decode_attn": 0.0, "elementwise": 0.0}
    for name, ms in kernels.items():
        if "decode_attn" in name:
            out["decode_attn"] += ms
        elif re.search(r"gemm|gemv|nvjet|xmma|cutlass|splitK", name, re.I):
            out["GEMV/GEMM"] += ms
        else:
            out["elementwise"] += ms
    return out


def _step_bytes(model, cache, B):
    """What one decode step must move at least: every weight the decode
    reads (all but the embedding table, a VLM's projector and an
    enc-dec's encoder) once, B embedding rows, and the cache once; an
    SSM's state is also written anew once."""
    from repro_torch.core.graphs import tensor_leaves
    from repro_torch.models.arch import SSMModel

    w = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
            if n not in ("tok", "projector", "enc_norm")
            and not n.startswith("encoder."))
    rows = B * model.tok.shape[1] * model.tok.element_size()
    state = sum(t.numel() * t.element_size() for t in tensor_leaves(cache))
    return w + rows + state * (2 if isinstance(model, SSMModel) else 1)


def model_serve(torch, results, tag, model, batch, steps, step_counts,
                pos0=None):
    """One model's serve path at full width: a warm-up prefill at the
    timed shape, then ``make_prefill_step`` on ``batch`` and ``steps``
    greedy steps through ``make_serve_step`` (graphs) from position
    ``pos0`` (the prompt's length unless given), every launch
    counter zeroed just before each and read just after (the prefill
    launches no ``decode_attn``; a decode step launches ``step_counts``,
    by kernel); the decode again eagerly and with graphs, in turns, from
    copies of the post-prefill cache, with identical greedy tokens; one
    profiled graph step split by kernel class, beside the step's byte
    bound.  Returns (record, the post-prefill cache's copy, the prompt's
    logits)."""
    from repro_torch.core.graphs import read_counters, write_counters
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.tree import tree_map

    cfg = model.cfg
    prefill, serve_step = make_prefill_step(model), make_serve_step(model)
    eager_step = make_serve_step(model, graphs=False)
    prefill(batch)                              # warm-up at the timed shape
    torch.cuda.synchronize()
    zero = lambda: write_counters({n: 0 for n in read_counters()})
    counted = lambda: {n: c for n, c in read_counters().items() if c}

    zero()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = prefill(batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    c_pre = counted()
    peak_prefill = torch.cuda.max_memory_allocated()
    S = batch["tokens"].shape[1] if pos0 is None else pos0   # positions
    log(f"{tag} prefill {LM_B} x {S}: {prefill_ms:.1f} ms "
        f"({prefill_ms / (S * cfg.n_layers):.4f} ms per position and "
        f"decoder layer), launches {c_pre}, peak "
        f"{peak_prefill / 2**30:.2f} GiB")
    assert "decode_attn" not in c_pre, c_pre
    assert logits.shape == (LM_B, 1, cfg.vocab_padded), logits.shape
    assert torch.isfinite(logits).all(), f"{tag} prefill: non-finite logits"

    clone = lambda c: tree_map(lambda t: t.clone(), c)
    base = clone(cache)
    tok0 = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
    pos = torch.full((LM_B,), S, device="cuda")

    def decode(step, c, check=False):
        """(ms of the first step, ms per later step, ms per step over all,
        tokens, last logits)."""
        tok, out = tok0, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            before = read_counters()
            lg, c = step(c, {"token": tok, "pos": pos + i})
            if check:
                after = read_counters()
                got = {n: after[n] - before[n] for n in after
                       if after[n] != before[n]}
                assert got == step_counts, (tag, i, got, step_counts)
            tok = lg[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
            out.append(tok)
            if i == 0:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return ((t1 - t0) * 1e3, (t2 - t1) * 1e3 / (steps - 1),
                (t2 - t0) * 1e3 / steps, torch.cat(out, 1), lg)

    zero()
    torch.cuda.reset_peak_memory_stats()
    first_ms, rest_ms, decode_ms, gen_toks, lg = decode(serve_step, cache,
                                                        check=True)
    c_dec = counted()
    peak_decode = torch.cuda.max_memory_allocated()
    assert c_dec == {n: c * steps for n, c in step_counts.items()}, c_dec
    assert torch.isfinite(lg).all(), f"{tag} decode: non-finite logits"
    assert ((gen_toks >= 0) & (gen_toks < cfg.vocab)).all()
    for n in set(c_pre) | set(c_dec):
        results[n]["launches"] += c_pre.get(n, 0) + c_dec.get(n, 0)
    nbytes = _step_bytes(model, cache, LM_B)
    bound_ms = nbytes / HBM_BW * 1e3
    turns = {"graphs": [(first_ms, rest_ms, decode_ms)], "eager": []}
    for who in ("eager", "eager", "graphs"):
        f, r, d, toks, _ = decode(eager_step if who == "eager" else serve_step,
                                  clone(base))
        assert torch.equal(toks, gen_toks), f"{tag} decode ({who}): other tokens"
        turns[who].append((f, r, d))
    graph_pool = serve_step.runner.pool_bytes()
    log(f"{tag} decode {steps} steps: graphs {turns['graphs']}, eager "
        f"{turns['eager']} ms per step (first, later, all); greedy tokens "
        f"identical; launches {c_dec}; byte bound {bound_ms:.4f} ms "
        f"({nbytes / 1e9:.3f} GB); graph pool {graph_pool / 2**20:.1f} MiB")
    probe = clone(base)
    one = {"token": tok0, "pos": pos}
    serve_step(probe, one)                        # capture
    prof = profile_fn(torch, f"{tag} decode step (graphs)",
                      lambda: serve_step(probe, one), 5)
    split = _kernel_classes(prof["kernels"])
    log(f"{tag} decode step by class: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in split.items())
        + f" of {prof['busy_ms']:.4f} ms device busy")
    rec = dict(layers=cfg.n_layers, params=sum(p.numel()
                                                for p in model.parameters()),
               dtype=cfg.dtype, batch=LM_B, prompt=S, steps=steps,
               prefill_ms=prefill_ms,
               prefill_ms_per_position_layer=prefill_ms / (S * cfg.n_layers),
               decode_ms_per_step=decode_ms, decode_first_ms=first_ms,
               decode_later_ms=rest_ms, decode_turns=turns,
               decode_bytes=nbytes, decode_bound_ms=bound_ms,
               peak_prefill_bytes=peak_prefill, peak_decode_bytes=peak_decode,
               graph_pool_bytes=graph_pool, launches_prefill=c_pre,
               launches_decode=c_dec, profile_decode=dict(prof, classes=split),
               generated=gen_toks.tolist())
    return rec, base, logits, eager_step


def card_vs_cpu(torch, tag, cfg, variants, batch_of=None, init=None,
                counts=None):
    """float32 copies of ``cfg`` on the card and the CPU from the same
    weights (seed 2, then ``init(model)``): the prefill of
    ``batch_of(device)`` (LM_B x LM_CPU_S tokens by default) and
    LM_CPU_STEPS greedy decode steps (the CPU's tokens fed to both),
    logits within ``limit`` of the largest |logit| for each (variant,
    limit): "reference init" the weights as drawn, "wq/wk at fan-in d"
    every attention's wq and wk then rescaled to fan-in d_model (the
    reference's rule takes the head count).  A variant in LM_PLANTED
    runs the weights as they stand with that fault planted on the card
    (TF32 products; a MoE's shared experts dropped), and its reading
    must exceed ``limit``: the check catches it.  Every variant is read
    before any is judged.  ``counts``: the card prefill's launches by
    kernel, checked.  Returns {variant: {step: reading}}."""
    import dataclasses

    import numpy as np
    from repro_torch.core.graphs import read_counters
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model

    cfg = dataclasses.replace(cfg, dtype="float32")
    if batch_of is None:
        batch_of = lambda dev: {"tokens": torch.as_tensor(
            np.random.default_rng(3).integers(0, cfg.vocab,
                                              (LM_B, LM_CPU_S)), device=dev)}
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    if init:
        init(cpu)
    readings = {}
    for variant, limit in variants:
        if variant == "wq/wk at fan-in d":
            with torch.no_grad():
                for n, w in cpu.named_parameters():
                    if n.endswith(("attn.wq", "attn.wk")):
                        w.mul_(math.sqrt(w.shape[-2] / w.shape[-3]))
        else:
            assert variant == "reference init" or variant in LM_PLANTED, \
                variant
        gpu = build_model(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        if variant == "shared experts dropped":
            with torch.no_grad():
                gpu.layers.moe.shared_wo.zero_()
        worst = readings[variant] = {}

        def close(step, a, b):
            worst[step] = (a.cpu() - b).abs().max().item() / \
                b.abs().max().item()

        torch.backends.cuda.matmul.allow_tf32 = variant == "TF32 on"
        try:
            before = read_counters()
            lg, cg = make_prefill_step(gpu)(batch_of("cuda"))
            after = read_counters()
            if counts is not None:
                got = {n: after[n] - before[n] for n in after
                       if after[n] != before[n]}
                assert got == counts, (tag, got, counts)
            cb = batch_of("cpu")
            lc, cc = make_prefill_step(cpu)(cb)
            close("prefill", lg, lc)
            sg, sc = make_serve_step(gpu), make_serve_step(cpu)
            S = cb["tokens"].shape[1]
            for i in range(LM_CPU_STEPS):
                tok = lc[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
                pos = torch.full((tok.shape[0],), S + i)
                lg, cg = sg(cg, {"token": tok.cuda(), "pos": pos.cuda()})
                lc, cc = sc(cc, {"token": tok, "pos": pos})
                close(f"decode {i}", lg, lc)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        log(f"{tag} card vs CPU ({variant}"
            f"{', planted' if variant in LM_PLANTED else ''}; float32, "
            f"{cfg.n_layers} layers, {tuple(cb['tokens'].shape)} + "
            f"{LM_CPU_STEPS} steps): prefill {worst['prefill']:.2e}, decode "
            f"at most {max(v for k, v in worst.items() if k != 'prefill'):.2e}"
            f" of max |logit| (limit {limit})")
        del gpu, cg, sg
        torch.cuda.empty_cache()
    for variant, limit in variants:
        top = max(readings[variant].values())
        if variant in LM_PLANTED:
            assert top > limit, (f"{tag}: the planted fault '{variant}' "
                                 f"reads {top:.2e}, within the limit {limit}")
        else:
            assert top <= limit, (f"{tag} ({variant}) card vs CPU: {top:.2e} "
                                  f"of max |logit| over {limit}")
    return readings


def lm_serve(torch, results, arch, n_layers, S, steps):
    """One config at full width: build and draw the weights (seed 0),
    then ``model_serve`` on LM_B prompts of S tokens (a VLM's 256
    frontend embeddings first), one ``decode_attn`` launch a layer and
    step; ``decode_attn`` is also held against its twin and float64 on
    layer 0 of the prefill's cache.  The ring is the prefill's F + S
    slots and, as in the reference, every slot is live (no length mask),
    so decode step i overwrites prompt token i: the oldest prompt tokens
    are evicted, as a window of F + S would."""
    import dataclasses

    import numpy as np
    from repro_torch.models import build_model, get_config

    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    L, F_ = cfg.n_layers, cfg.n_frontend_tokens
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda").init(
        torch.Generator().manual_seed(0))
    build_s = time.perf_counter() - t0
    log(f"{arch}: {L} layers, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
        f"parameters ({cfg.dtype}), built and drawn in {build_s:.1f} s")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (LM_B, S)),
                                       device="cuda")}
    if cfg.family == "vlm":
        batch["frontend"] = torch.randn(
            (LM_B, F_, cfg.d_model), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(1)).to(
                model.projector.dtype)
    rec, base, _, _ = model_serve(torch, results, arch, model, batch, steps,
                                  {"decode_attn": L}, pos0=F_ + S)
    assert [tuple(t.shape) for t in base] == [
        (L, LM_B, F_ + S, cfg.n_kv_heads, cfg.head_dim)] * 2
    q0 = torch.randn((LM_B, cfg.n_heads, cfg.head_dim), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(2))
    e, atol, _, rel = _decode_check(torch, results,
                                    f"{arch} prefill cache, layer 0",
                                    q0.to(base[0].dtype), base[0][0],
                                    base[1][0])
    log(f"{arch} decode_attn on layer 0 of the prefill cache: |kernel - "
        f"twin| {e:.3e} (limit {atol:.3e}), float64 {rel:.2e} of max |out|")
    rec.update(build_s=build_s, frontend=F_,
               prefill_tok_s=LM_B * (F_ + S) * 1e3 / rec["prefill_ms"],
               decode_tok_s=LM_B * 1e3 / rec["decode_later_ms"])
    results.setdefault("_lm", {})[arch] = rec


def lm_phase(torch, results):
    """The Transformer family's serve path: ``decode_attn`` at its
    groups, qwen3_4b at full width and depth (2 x 8192 prefill, 32
    decode steps), deepseek_moe_16b at full width cut to 4 layers (2 x
    2048, 32 steps), internvl2_2b at full width and depth (2 x (256 +
    2048), 8 steps), then card against CPU for qwen3_4b and
    deepseek_moe_16b (the latter also with LM_PLANTED's faults, and with
    wq / wk at fan-in d)."""
    import dataclasses
    import gc

    lm_kernel_checks(torch, results)
    for run in LM_RUNS:
        lm_serve(torch, results, *run)
        gc.collect()                      # the model, its caches, its graphs
        torch.cuda.empty_cache()
    from repro_torch.models import get_config

    def cut(arch):
        return dataclasses.replace(get_config(arch), n_layers=LM_CPU_LAYERS)

    cvc = results.setdefault("_lm", {}).setdefault("card_vs_cpu_rel", {})
    cvc["qwen3_4b"] = card_vs_cpu(torch, "qwen3_4b", cut("qwen3_4b"),
                                  [("reference init", LM_REL)])
    cvc["deepseek_moe_16b"] = card_vs_cpu(
        torch, "deepseek_moe_16b", cut("deepseek_moe_16b"),
        [("reference init", LM_REL_INIT)]
        + [(fault, LM_REL_INIT) for fault in LM_PLANTED]
        + [("wq/wk at fan-in d", LM_REL)])


# --- phases 9-10: the SSM stacks (RWKV6, Mamba2) and the enc-dec --------------------

SSM_STEPS = 32                           # greedy decode steps
RWKV_S = 2048                            # rwkv6_1p6b's prompt tokens
MAMBA_LAYERS, MAMBA_S = 2, 1024          # ssm_mamba2 at zamba2_1p2b's widths
ED_S = 2048                              # seamless's prompt tokens (+ 1536 frames)
# rwkv6_1p6b's relay property in bf16 (prefill(P) + decode(token P) against
# prefill(P + 1)'s last logits), of the largest |logit|: the two run their
# GEMMs at other shapes (L = 1 against L = P + 1), so cuBLAS rounds the
# bf16 products at other places, and 24 layers carry a few bf16 ulps
# (2**-8 each) into the logits
RELAY_BF16 = 2 ** -5
# ... seamless at the reference init: no qk-norm, wq / wk's fan-in the head
# count (16), so its attention logits have a std of ~64 and the softmax over
# 1536 frames is near one-hot: a float32 reordering can move a row's pick
# (5.4e-2 of the largest |logit| read at the prefill on an H100).  Held at
# ED_REL_INIT, which a planted fault (TF32 products on the card) must
# exceed, and at LM_REL with wq / wk at fan-in d
ED_REL_INIT = 0.1


def ssm_phase(torch, results):
    """The attention-free stacks' serve path.  ``rwkv6_1p6b`` at full
    width and depth, bf16: 2 x 2048 prefill and 32 greedy steps
    (``model_serve``: every counter 0, RWKV6 reaches no kernel), the
    relay property in bf16, card vs CPU in float32 at 2 layers; then an
    ``ssm_mamba2`` stack at zamba2_1p2b's widths, 2 layers, float32,
    2 x 1024 on the card (one ``ssd_chunk_intra`` and one
    ``ssd_chunk_state`` launch a layer) against the CPU."""
    import dataclasses
    import gc

    import numpy as np
    from repro_torch.models import build_model, get_config

    cfg = get_config("rwkv6_1p6b")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda").init(
        torch.Generator().manual_seed(0))
    build_s = time.perf_counter() - t0
    log(f"rwkv6_1p6b: {cfg.n_layers} layers, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters "
        f"({cfg.dtype}), built and drawn in {build_s:.1f} s")
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (LM_B, RWKV_S)),
                              device="cuda")
    rec, base, logits, eager_step = model_serve(
        torch, results, "rwkv6_1p6b", model, {"tokens": prompts}, SSM_STEPS,
        {})
    log("rwkv6_1p6b: every launch counter read 0 in the prefill and the "
        "decode (RWKV6 reaches no kernel: its WKV scan is plain PyTorch, as "
        "in the reference)")
    rec["build_s"] = build_s

    # the relay property: prefill(P) then decode(token P) == prefill(P + 1)
    tok0 = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
    step, _ = eager_step(base, {"token": tok0,
                                "pos": torch.full((LM_B,), RWKV_S,
                                                  device="cuda")})
    full, _ = model.prefill({"tokens": torch.cat([prompts, tok0], 1)})
    relay = ((step.float() - full.float()).abs().max()
             / full.float().abs().max()).item()
    log(f"rwkv6_1p6b relay: prefill({RWKV_S}) + decode vs prefill("
        f"{RWKV_S + 1}): {relay:.2e} of max |logit| (limit {RELAY_BF16})")
    assert relay <= RELAY_BF16, relay
    rec["relay_rel"] = relay
    del model, base, eager_step
    gc.collect()
    torch.cuda.empty_cache()

    rec["card_vs_cpu_rel"] = card_vs_cpu(
        torch, "rwkv6_1p6b", dataclasses.replace(cfg, n_layers=LM_CPU_LAYERS),
        [("reference init", LM_REL)])

    mcfg = dataclasses.replace(get_config("zamba2_1p2b"), family="ssm_mamba2",
                               n_layers=MAMBA_LAYERS)

    def live_ssm(model):
        g = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for n in ("A_log", "dt_bias"):
                p = getattr(model.layers.mixer, n)
                p.copy_(0.5 * torch.randn(p.shape, generator=g))

    mamba = card_vs_cpu(
        torch, "ssm_mamba2 (zamba2_1p2b widths)", mcfg,
        [("reference init", HYB_REL)],
        batch_of=lambda dev: {"tokens": torch.as_tensor(
            np.random.default_rng(5).integers(0, mcfg.vocab, (LM_B, MAMBA_S)),
            device=dev)}, init=live_ssm,
        counts={"ssd_chunk_intra": MAMBA_LAYERS,
                "ssd_chunk_state": MAMBA_LAYERS})
    for n in ("ssd_chunk_intra", "ssd_chunk_state"):
        results[n]["launches"] += MAMBA_LAYERS
    log(f"ssm_mamba2: {MAMBA_LAYERS} ssd_chunk_intra and {MAMBA_LAYERS} "
        f"ssd_chunk_state launches in the card's prefill ({LM_B} x "
        f"{MAMBA_S}), one of each a layer")
    results["_ssm"] = {"rwkv6_1p6b": rec, "ssm_mamba2": dict(
        layers=MAMBA_LAYERS, prompt=MAMBA_S, card_vs_cpu_rel=mamba)}


def encdec_phase(torch, results):
    """The enc-dec's serve path.  ``decode_attn`` at seamless's two new
    shapes (G 1, D 64, bf16, B 2: the self ring of 2048 slots and the
    1536 cross slots) against its twin and float64, timed per call and
    by graph beside SDPA and the byte bound; ``seamless_m4t_large_v2``
    at full width and depth, bf16: 2 x (1536 frames + 2048 tokens), 32
    greedy steps (``model_serve``: 0 ``decode_attn`` launches in the
    prefill, 48 a step), the kernel on layer 0 of the prefill's own self
    and cross cache; card vs CPU in float32 at 2 + 2 layers, at the
    reference init and with wq / wk at fan-in d."""
    import dataclasses
    import functools
    import gc

    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attn as dk
    from repro_torch.models import build_model, get_config

    cfg = get_config("seamless_m4t_large_v2")
    H, KV, D, Fr = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.n_frontend_tokens
    gen = torch.Generator(device="cuda").manual_seed(8)
    record = functools.partial(_record, torch, results)
    for name, S in (("seamless self ring", ED_S), ("seamless cross", Fr)):
        q = torch.randn((LM_B, H, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((LM_B, S, KV, D), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        tag = f"{name} G {H // KV} B {LM_B} S {S} bfloat16"
        e, atol, rtol, rel = _decode_check(torch, results, tag, q, k, v)
        record("decode_attn", dict(config=name, B=LM_B, S=S, H=H, KV=KV,
                                   G=H // KV, D=D, dtype=str(q.dtype),
                                   atol=atol, rtol=rtol, f64_rel=rel,
                                   main=False), e,
               lambda: dk.decode_attn(q, k, v),
               lambda: dk.decode_attn_plain(q, k, v),
               4 * LM_B * H * S * D + 5 * LM_B * H * S,
               2 * (2 * LM_B * S * KV * D + 2 * LM_B * H * D),
               library=lambda: F.scaled_dot_product_attention(
                   q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)))

    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda").init(
        torch.Generator().manual_seed(0))
    build_s = time.perf_counter() - t0
    log(f"seamless_m4t_large_v2: {cfg.n_enc_layers} + {cfg.n_layers} layers, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters "
        f"({cfg.dtype}), built and drawn in {build_s:.1f} s")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                    (LM_B, ED_S)),
                                       device="cuda"),
             "frames": torch.randn((LM_B, Fr, cfg.d_model), generator=gen,
                                   device="cuda").to(torch.bfloat16)}
    rec, base, _, _ = model_serve(torch, results, "seamless_m4t_large_v2",
                                  model, batch, SSM_STEPS,
                                  {"decode_attn": 2 * cfg.n_layers})
    rec["build_s"] = build_s
    q0 = torch.randn((LM_B, H, D), generator=gen,
                     device="cuda").to(torch.bfloat16)
    for part in ("self", "cross"):
        ck, cv = base[part]
        e, atol, _, rel = _decode_check(
            torch, results, f"seamless prefill {part} cache, layer 0", q0,
            ck[0], cv[0])
        log(f"seamless decode_attn on layer 0 of the prefill's {part} cache "
            f"({tuple(ck[0].shape)}): |kernel - twin| {e:.3e} (limit "
            f"{atol:.3e}), float64 {rel:.2e} of max |out|")
    del model, base
    gc.collect()
    torch.cuda.empty_cache()

    cpu_cfg = dataclasses.replace(cfg, n_layers=LM_CPU_LAYERS,
                                  n_enc_layers=LM_CPU_LAYERS)

    def cpu_batch(device):
        r = np.random.default_rng(3)
        return {"tokens": torch.as_tensor(r.integers(0, cfg.vocab,
                                                     (LM_B, LM_CPU_S)),
                                          device=device),
                "frames": torch.as_tensor(r.normal(size=(
                    LM_B, Fr, cfg.d_model)).astype(np.float32),
                    device=device)}

    rec["card_vs_cpu_rel"] = card_vs_cpu(
        torch, "seamless_m4t_large_v2", cpu_cfg,
        [("reference init", ED_REL_INIT), ("TF32 on", ED_REL_INIT),
         ("wq/wk at fan-in d", LM_REL)], batch_of=cpu_batch)
    results["_encdec"] = {"seamless_m4t_large_v2": rec}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="kernels,serve,relay,graphs,costmodel,hybrid,"
                            "train,lm,ssm,encdec")
    ap.add_argument("--requests", type=int, default=24)
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from repro_torch.kernels import cuda_lib    # fails outside a checkout
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,uuid,power.limit,clocks.sm,"
         "clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card (name, uuid, power limit, SM clock, max SM clock): "
        f"{card.splitlines()[0]}")
    wall0 = time.perf_counter()

    torch.backends.cuda.matmul.allow_tf32 = False    # plain twins in full f32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_lib.library()
    log(f"built/loaded {sorted(set(SOURCES.values()))} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in cuda_lib.BUILD_LOG.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "entry function")):
            log(f"ptxas: {line.strip()}")

    results = {n: dict(launches=0, max_abs_err=0.0, shapes=[])
               for n in REPLACES}
    results["_serve"] = {}
    if "kernels" in phases:
        kernel_phase(torch, results)
    if "serve" in phases:
        serve_phase(torch, results, args.requests)
    if "relay" in phases:
        relay_phase(torch, results)
    if "graphs" in phases:
        graphs_phase(torch, results, args.requests)
    if "costmodel" in phases:
        costmodel_phase(torch, results)
    if "hybrid" in phases:
        hybrid_phase(torch, results)
    if "train" in phases:
        train_phase(torch, results)
    if "lm" in phases:
        lm_phase(torch, results)
    if "ssm" in phases:
        ssm_phase(torch, results)
    if "encdec" in phases:
        encdec_phase(torch, results)

    kernels = []
    for name, path in REPLACES.items():
        r = results[name]
        main_shape = next((sh for sh in r["shapes"] if sh.get("main")), {})
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": path, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"],
            "ms": main_shape.get("ms"), "graph_ms": main_shape.get("graph_ms"),
            "plain_ms": main_shape.get("plain_ms"),
            "bound_ms": main_shape.get("bound_ms"),
            "bound_by": main_shape.get("bound_by"),
            "bound_tf32_ms": main_shape.get("bound_tf32_ms"),
            "library_ms": main_shape.get("library_ms"),
            "shape": {k: main_shape[k] for k in (
                "B", "S", "P", "spans", "n_incr", "n_items", "L", "Q", "H",
                "N", "KV", "D", "dtype") if k in main_shape},
        })
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "card_ids": card,
                   "build_log": cuda_lib.BUILD_LOG,
                   "wall_s": time.perf_counter() - wall0,
                   "results": results}, f, indent=1)
    log(f"phases {sorted(phases)}: {time.perf_counter() - wall0:.1f} s of "
        f"wall, the build included")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
