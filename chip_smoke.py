#!/usr/bin/env python3
"""Chip smoke for the PyTorch / Hopper port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card, every phase

Phases, each fatal on failure (nothing is caught):

  1. require ``torch.cuda.is_available()``; print the card's name and
     power limit as ``nvidia-smi`` reports them, and log its UUID and
     SM clocks (now and at most) beside them;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``,
     cached in ``build/kernels/`` by a hash of the sources);
  3. print the registers, spill bytes and shared memory of the paged
     loader's variants (the TMA-loaded paged and segment
     launches, rows 3-4); hold each kernel against its plain-PyTorch
     version on the card at the live shapes (B in {1, 8}, H=4, D=64,
     2048-token psi, 16 incr + 64 items), at the paper's ranking shape
     (64 incr + 512 items over 2048 tokens) and, for the paged kernel,
     with 64-token pages and ragged per-row lengths (the main shape), at
     full rows (every row 2048 tokens: the dense launch's work; row 4 as
     one span a row) and at B 1; assert the bitwise properties (a row's
     result does not depend on its batch; paged == dense at equal padded
     length; the segment kernel with one span == the paged kernel; a
     graph replay == the eager launch), the paged and segment launches
     within 1e-5 of the largest |out| of their twins in float64 and
     within 1e-4 of their twins on the CPU; with every pool key that no
     launch holds set to NaN (page tails past prefix_lens or
     page_valid, pages no table names), the paged and segment outputs
     finite and equal to the clean pool's bit for bit (float32 and bf16,
     16- and 64-token pages, B 1 and 8); the
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
     CUDA events; then rows 1-4 with bf16 inputs at their main shapes
     (B 8), rows 2-4 also at full rows and B 1: each bf16 launch equal
     bit for bit to the float32 launch on
     the widened inputs, rounded to bf16; that float32 launch within
     1e-5 of the largest |out| of float64 on the widened inputs, the
     bf16 output within its rounding (2**-8 of |out|) plus 1e-5; within
     BF16_TWIN of the largest |out| of its bf16 twin;
     two calls, paged == dense, one-span segment == paged and a row
     against its batch bit for bit, in bf16; timed as above, the bound
     at bf16 bytes;
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
  5a. ``bf16``: a bf16 ``hstu-gr`` (``dataclasses.replace(cfg,
     dtype="bfloat16")``) at full width, random weights from a seed: the
     five serve modes of phase 4 with graphs and their checks, the
     counters zeroed just before and read just after each (rows 1-4
     launched at bf16), hits, rank p50 / p99; psi's bytes a user at 2048
     tokens; |relay - full| within BF16_RELAY_REL and card vs the port
     on the CPU within BF16_CPU_REL of the largest |score|;
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
     the same function; the SSD kernels on bf16 x, B and C (strided
     views of one xBC, as the model hands them over): each launch equal
     bit for bit to the float32 launch on widened inputs (the intra's
     bf16 output to it rounded), float64 within 1e-5, rows and repeat
     calls bit for bit, timed at bf16 bytes; then, after a warm-up
     prefill at the same shape,
     2 prompts x 8192 tokens through
     ``make_prefill_step`` (eager) and 32
     greedy steps through ``make_serve_step`` (a CUDA-graph replay per
     step after the first), counters zeroed
     just before each and read just after (38 + 38 SSD launches per
     prefill, every one taking bf16 x, B and C, 6 decode launches per
     step); layer 0's Mamba2 mixer at 2 x 8192 equal bit for bit to the
     route that hands each SSD kernel float32 copies; the decode again
     eagerly and
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
     per call and by graph beside the byte bound and SDPA; then its
     log-sum-exp (``lse=True``, written by the same launch) at the
     hybrid's main shape, at ``qwen3_4b``'s heads over one rank's 16384
     slots of the kv_seq ring and in float32 over a ragged ring: within
     1e-4 of its twin's and float64's, ``out`` the same bits with it, a
     ring in 4 parts merged by the parts' lse against one launch, the
     call timed with and without it.  Then, bf16,
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
     ``deepseek_moe_16b`` at full width cut to 2 of 28 layers (2 x 2048,
     32 steps) and ``internvl2_2b`` at full width cut to 8 of 24 layers
     (2 x (256 frontend + 2048), 8 steps), both cut for the run's time;
     last, card against CPU for float32 copies of qwen3_4b and
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
 11. ``lmtrain``: LM training for every family.  The SSD Functions
     (``ssd_chunk_intra`` / ``ssd_chunk_state``: the kernel forward, a
     float32 backward) against float64 autograd of the twins' einsums at
     the zamba2 train step's shape per layer (B 2, L 4096, Q 128, H = P
     = N = 64) and a ragged one (chunks of 100), every input's gradient
     within 1e-5 of its largest |g|, each backward timed beside its
     forward kernel; then the main path: ``zamba2_1p2b`` at full width
     and depth (38 layers, 3.02 B, bf16), B 2 x 4096 (``train_4k``'s
     sequence, its batch of 256 cut to 2), the launcher's schedule on
     its synthetic batches (AdamW with the global-norm clip off, see
     LMT_ADAMW), 2 warm-up and 10 timed AdamW steps through
     ``make_train_step``, the counters zeroed between and read after
     (76 launches of each SSD kernel a step: 38 forward, 38 in the
     checkpoint's recompute; the backward launches none; every launch
     takes bf16 x, B and C), layer 0's Mamba2 mixer at 2 x 4096,
     forward and backward, equal bit for bit to the float32-copy route
     (output, states and every gradient), ms/step,
     tokens/s, peak memory (under 75 GiB), a finite loss that falls
     (the last 3 steps' mean below the first 3's, and on the first
     batch after the last step below before the first), every gradient
     present and finite, what a clip of 1.0 would freeze, and one
     profiled step split into forward and backward GEMMs, the SSD
     kernels, the SSD backward, the plain attention (forward and
     backward), unembed/CE, the layer-slice gradients of the stacked
     weights, AdamW and the elementwise rest; card vs CPU for the hybrid
     at zamba2's widths and 2 layers, float32, 1 x 256 (the loss 1e-5
     relative, each gradient 1e-3 of its largest |g| at the reference
     init, whose near one-hot shared attention makes float32 reorderings
     show, and 1e-4 with wq / wk at fan-in d), and with the intra
     wrapper planted on the bare launch (no gradient through it), which
     must read above 1e-4; then every other family at full width, cut
     in depth only, 3-4 AdamW steps each on one batch with a finite,
     falling loss and every gradient present: ``qwen3_4b`` 4 of 36 layers, 2 x 4096;
     ``deepseek_moe_16b`` 2 of 28, 2 x 2048 (aux logged); ``internvl2_2b``
     4 of 24, 2 x (256 + 2048); ``rwkv6_1p6b`` 2 of 24, 2 x 512 (the
     plain WKV loop); ``seamless_m4t_large_v2`` 2 + 2 layers, 2 x (1536
     frames + 512); an ``ssm_mamba2`` stack at zamba2's widths, 2
     layers, 2 x 1024 (two launches of each SSD kernel a layer and
     step);
 11b. ``dist``: the port under a process mesh, DIST_W ranks spawned
     from this process (NCCL with a card each where there are DIST_W
     cards, else gloo with every rank on cuda:0, printed; a time under
     shared-card gloo is not a multi-GPU figure): ``hstu-gr`` at full
     width on (2, 2) in float32, 3 AdamW steps of 4 x 2048 (the loss and
     grad_norm within 1e-5 of one process's) and a 4 x 2048 prefill with
     ``rank_with_cache`` (16 + 64), the logits and scores within 1e-4 of
     the largest |value|, ``hstu_attn`` and ``prefix_rank_attn`` launched
     on 2 heads a rank; ``qwen3_4b`` at full width, 4 of its 36 layers,
     bf16, on (1, 4): a 2 x 2048 prefill and 16 decode steps,
     ``decode_attn`` on 8 q / 2 kv heads a rank, and at 2 layers in
     float32 the logits
     within 1e-4 of one process's; ``deepseek_moe_16b`` at full width,
     2 layers, float32, on (1, 4), expert-parallel (16 experts a rank),
     likewise; ``zamba2_1p2b`` at full width, one section (6 Mamba2
     blocks and the shared attention), bf16, on (1, 4): a 2 x 2048
     prefill, 16 decode steps and 2 AdamW steps, the SSD kernels on 16
     of 64 heads and ``decode_attn`` on 8 of 32 a rank, within 2^-5 of
     one process's logits, loss and grad_norm; ``rwkv6_1p6b`` 2 layers
     in float32 on (1, 4) and ``seamless_m4t_large_v2`` 2 + 2 layers in
     float32 on (2, 2), within 1e-4 / 1e-5; one sequence over a
     65536-slot ring on (4, 1) under the kv_seq rule (``qwen3_4b`` bf16
     2 layers and the zamba2 section, 16 steps each, ``decode_attn`` on
     16384 slots a rank, merged by its log-sum-exp), within 2^-5 of one
     process's decode of the whole ring; FSDP (every weight's "embed"
     dimension on "data", gathered a layer at a time): ``hstu-gr`` as
     above on (2, 2) (train, prefill, ``rank_with_cache``) and the
     zamba2 section on (4, 1), 4 x 2048 + 8 steps + 2 AdamW steps
     (kernels 5-7 on every head); ZeRO-2 (the moments on "data"):
     ``hstu-gr``'s train steps on (2, 2), the parameters the same bits
     on every data rank; each against one process within the limits
     above, each rank's bytes of parameters and moments equal to the
     dry-run's sizing; each workload's collectives a step, every
     rank's, equal to the meta dry-run's at the same shape, mesh and
     rules; one ``{"dist": ...}`` line is printed before the kernels
     line;
 12. ``dryrun``: ``repro_torch.launch.dryrun`` on the meta device for
     every arch x input shape at full config and shape, on the 1 x 1,
     16 x 16 and 2 x 16 x 16 meshes, in DRY_JOBS processes (the records
     in ``chiprun_out/dryrun/``): no failure, the skipped set the
     reference's ``_should_skip``, a sizing line per 1 x 1 and 16 x 16
     record (arguments per device, whether one H100 holds them); then,
     for every step the phases above timed (DRY_TIMED), its FLOPs and
     arguments counted at the timed shape beside the phase's own time:
     model FLOPs, MFU and the roofline share against the published
     peak of the config's type, with the card's name and power limit;
     the live arguments the phase kept predicted to the byte (int64
     serve tokens at twice the int32 spec) and its peak above them;
 13. print the ``kernels`` JSON line, then the final device line; the
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

from repro_torch.launch.mesh import (HBM_BW,       # noqa: E402
                                     PEAK_FLOPS_FP32 as FP32_PEAK,
                                     PEAK_FLOPS_TF32 as TF32_PEAK)

TOL = 3e-4          # f32 kernel vs plain: the repo's kernel tolerance
BF16_REL = 2 ** -6  # bf16 decode vs plain: of the largest |plain|, ~2 bf16 ulps
F64_REL = 1e-5      # rank kernels vs float64: of the largest |out|
CPU_REL = 1e-4      # rank kernels on the card vs their twins on the CPU
GRAPH_REL = 1e-6    # graph replay vs eager, of the largest |value|
H, D = 4, 64
PSI, N_INCR, N_ITEMS = 2048, 16, 64
PAGE = 64
RAGGED = [2048, 1500, 933, 103, 2048, 640, 1, 1777]   # per-row psi tokens
# per row: ('c', n) a cached span, ('f', n) fresh tokens (the last 64 items)
SEG_PATTERN = [("c", PSI), ("f", 8), ("c", 96), ("f", 8), ("c", 160),
               ("f", N_ITEMS)]
# spans that end mid-page at 16- and 64-token pages (the NaN-pool check)
NAN_PATTERN = [("c", PSI - 40), ("f", 8), ("c", 90), ("f", 8), ("c", 150),
               ("f", N_ITEMS)]

# bf16 inputs (rows 1-4 and 6-7 widen on load, as the Pallas kernels do)
BF16_OUT = 2 ** -8  # a bf16 output's rounding, of its |value|
# bf16 kernel vs its bf16 twin, of the twin's largest |out|: the twins of
# rows 1-4 round their logits and scores to bf16 (the reference's
# oracles), the kernel keeps float32 (0.004-0.006 on the CPU at these
# shapes, the twin against the widened float32 twin rounded to bf16)
BF16_TWIN = 2 ** -6

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


def _nbytes(tree):
    """Bytes of every tensor of a tree (dicts, tuples, lists)."""
    from repro_torch.tree import leaves
    return sum(t.nbytes for t in leaves(tree))


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


def _graph_ms(torch, fn, n=20, reps=5, want=None):
    """The card's time per launch of ``fn``: n launches captured in a
    CUDA graph, replayed ``reps`` times between CUDA events, the least of
    3 samples.  No host time is in it (the wrapper runs at capture).
    With ``want``, a replay's output must equal it bit for bit."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            out = fn()
    graph.replay()
    torch.cuda.synchronize()
    if want is not None:
        assert torch.equal(out, want), "graph replay != eager bitwise"
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


def _rank_times(torch, fn, plain, flops, nbytes, want=None):
    """A rank kernel's times at one shape: ``ms`` back-to-back wrapper
    calls (host included, as every kernel here is timed), ``graph_ms``
    the card's time per launch (CUDA-graph replay, no host; with
    ``want``, the replay's bits checked against it), the plain twin per
    call, and both bounds."""
    bound_ms, by = _bound(flops, nbytes)
    return dict(ms=_time_ms(torch, fn),
                graph_ms=_graph_ms(torch, fn, want=want),
                plain_ms=_time_ms(torch, plain, 5), bound_ms=bound_ms,
                bound_by=by, bound_tf32_ms=_bound_tf32(flops, nbytes))


def _visible_new(Sq, n_incr):
    """(query, key) pairs the rank mask keeps among the new tokens."""
    incr = n_incr * (n_incr + 1) // 2
    items = (Sq - n_incr) * (n_incr + 1)
    return incr + items


def paged_build_report(torch):
    """The paged loader's variants (PAGED: the paged and segment launches)
    as ptxas built them: registers, spill bytes and static shared memory
    from ``cuda_lib.BUILD_LOG``, the dynamic shared memory from the
    library; one line each."""
    import ctypes
    from repro_torch.kernels import cuda_lib
    lib = cuda_lib.library()
    lib.hstu_rank_attn_paged_smem.argtypes = [ctypes.c_int] * 3
    lib.hstu_rank_attn_paged_smem.restype = ctypes.c_int
    kind = re.compile(r"hstu_rank_attn_kernelILi(\d+)ELb([01])ELb([01])E"
                      r"(f|13__nv_bfloat16)E")
    found, name = {}, None
    for line in cuda_lib.BUILD_LOG.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        k = kind.search(name or "")
        if not k or k.group(2) != "1":
            continue
        key = (int(k.group(1)), k.group(3) == "1",
               "bf16" if k.group(4) != "f" else "f32")
        r = found.setdefault(key, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            r["spill_stores"], r["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            r["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            r["static_smem"] = int(m.group(1)) if m else 0
    assert found, "no paged variant of hstu_rank_attn_kernel in the build log"
    rows = []
    for (d, seg, t), r in sorted(found.items()):
        r["dynamic_smem"] = lib.hstu_rank_attn_paged_smem(
            d, int(seg), int(t == "bf16"))
        rows.append(dict(D=d, segment=seg, dtype=t, **r))
        log(f"paged variant D={d} {'SEG' if seg else 'paged'} {t}: "
            f"{r.get('registers')} registers, {r.get('spill_stores')} / "
            f"{r.get('spill_loads')} bytes spilled (stores / loads), shared "
            f"memory {r['dynamic_smem']} B dynamic + {r.get('static_smem')} B "
            f"static")
    return rows


def _f64_and_cpu(torch, got, plain, args):
    """``got`` (a rank kernel's float32 output) against ``plain`` on
    ``args`` in float64 on the card and in float32 on the CPU, each of
    the largest |out|; asserts F64_REL and CPU_REL."""
    wide = tuple(a.double() if a.is_floating_point() else a for a in args)
    ref64 = plain(*wide)
    f64 = ((got.double() - ref64).abs().max() / ref64.abs().max()).item()
    cpu = plain(*(a.cpu() for a in args))
    rel = ((got.cpu() - cpu).abs().max() / cpu.abs().max()).item()
    assert f64 <= F64_REL, f"|kernel - float64| {f64:.2e} of max |out|"
    assert rel <= CPU_REL, f"|card - CPU| {rel:.2e} of max |out|"
    return f64, rel


def _held(torch, n_pool, pt, tables, held_tokens):
    """(n_pool, pt) bool: the pool keys some launch row holds, slot s of
    row b holding its page's first ``held_tokens[b, s]`` keys."""
    j = torch.arange(pt, device=held_tokens.device)
    rows = (j[None, None, :] < held_tokens[:, :, None]).int()
    count = torch.zeros(n_pool, pt, dtype=torch.int32,
                        device=held_tokens.device)
    for table in tables:
        count.index_put_((table.reshape(-1).long(),), rows.reshape(-1, pt),
                         accumulate=True)
    return count > 0


def unheld_nan_checks(torch, results):
    """TMA loads whole pages, so the keys a launch does not hold reach
    shared memory: the tail of a row's last page past prefix_lens, a
    segment page's keys past page_valid, pages no table names.  With all
    of them NaN, the paged and segment outputs are finite and equal the
    clean pool's (those keys 0) bit for bit: float32 and bf16, 16- and
    64-token pages, B 1 and 8 (ragged rows, the segment pattern)."""
    from repro_torch.kernels import paged_prefix_attn as pk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    nan = torch.tensor(float("nan"), device=dev)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for pt in (16, 64):
            for B in (1, 8):
                lens = RAGGED[:B] if B > 1 else [PSI - 48]
                n_pages = PSI // pt
                n_pool = 2 * B * n_pages
                pool = torch.randn(n_pool + 1, pt, H, D, generator=gen,
                                   device=dev)
                perm = torch.randperm(n_pool, generator=gen, device=dev).int()
                kt = torch.full((B, n_pages), n_pool, dtype=torch.int32,
                                device=dev)
                vt = kt.clone()
                for b, ln in enumerate(lens):
                    used = -(-ln // pt)
                    kt[b, :used] = perm[2 * b * n_pages:2 * b * n_pages + used]
                    vt[b, :used] = perm[(2 * b + 1) * n_pages:
                                        (2 * b + 1) * n_pages + used]
                plens = torch.tensor(lens, dtype=torch.int32, device=dev)
                slot = torch.arange(n_pages, device=dev) * pt
                keep = _held(torch, n_pool + 1, pt, (kt, vt),
                             (plens[:, None] - slot).clamp(0, pt))
                q, kn, vn = (torch.randn(B, H, N_INCR + N_ITEMS, D,
                                         generator=gen, device=dev).to(dtype)
                             for _ in range(3))
                clean = torch.where(keep[..., None, None], pool, 0).to(dtype)
                bad = torch.where(keep[..., None, None], pool, nan).to(dtype)
                call = lambda p: pk.paged_prefix_rank_attn(
                    q, p, p, kt, vt, plens, kn, vn, n_incr=N_INCR)
                got, want = call(bad), call(clean)
                assert torch.isfinite(got).all(), "paged: NaN from unheld keys"
                assert torch.equal(got, want), "paged: unheld keys changed bits"
                a = _segment_inputs(torch, gen, B, page=pt,
                                    pattern=NAN_PATTERN, pad=1)
                n_items = a.pop("n_items")
                keep = _held(torch, a["k_pages"].shape[0], pt,
                             (a["k_table"], a["v_table"]), a["page_valid"])
                spool = a.pop("k_pages")
                a.pop("v_pages")
                a = {k: v.to(dtype) if v.is_floating_point() else v
                     for k, v in a.items()}
                clean = torch.where(keep[..., None, None], spool, 0).to(dtype)
                bad = torch.where(keep[..., None, None], spool, nan).to(dtype)
                seg = lambda p: pk.segment_rank_attn(
                    k_pages=p, v_pages=p, **a, n_items=n_items)
                got, want = seg(bad), seg(clean)
                assert torch.isfinite(got).all(), "segment: NaN from unheld keys"
                assert torch.equal(got, want), "segment: unheld keys changed bits"
                cases += 1
    results["paged_prefix_rank_attn"]["unheld_nan_cases"] = cases
    results["segment_rank_attn"]["unheld_nan_cases"] = cases
    log(f"unheld pool keys NaN: paged and segment outputs finite and equal "
        f"to the clean pool's bit for bit in {cases} cases (float32 / bf16, "
        f"16- / 64-token pages, B 1 / 8)")


def kernel_phase(torch, results):
    from repro_torch.kernels import hstu_attn as hk
    from repro_torch.kernels import paged_prefix_attn as pk
    from repro_torch.kernels import prefix_rank_attn as rk
    from repro_torch.kernels import ref

    results["_paged_build"] = paged_build_report(torch)

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

    # prefix_rank_attn + paged (and the one-span segment): the live rank
    # of one hit (B 1, 2048 psi), the ragged batch (main), the same batch
    # at full rows (the dense launch's work), the paper's ranking shape
    for B, n_incr, n_items, rows in ((1, N_INCR, N_ITEMS, "full"),
                                     (8, N_INCR, N_ITEMS, "ragged"),
                                     (8, N_INCR, N_ITEMS, "full"),
                                     (1, 64, 512, "full")):
        Sq = n_incr + n_items
        lens = RAGGED[:B] if rows == "ragged" else [PSI] * B
        main = (B, n_incr, rows) == (8, N_INCR, "ragged")
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
        seg_call = lambda: pk.segment_rank_attn(
            q, pool, pool, kt, vt, ppos, pval, qpos, kn, vn, n_items=n_items)
        seg = seg_call()
        assert torch.equal(seg, paged), (
            f"segment (one span) != paged bitwise "
            f"(max {(seg - paged).abs().max():.3e})")
        # bitwise: two calls on the same inputs, every mode
        for mode, again, first in (
                ("dense", lambda: rk.prefix_rank_attn_split(
                    q, kp, vp, kn, vn, n_incr=n_incr), dense),
                ("paged", lambda: pk.paged_prefix_rank_attn(
                    q, pool, pool, kt, vt, plens, kn, vn, n_incr=n_incr), paged),
                ("segment", seg_call, seg)):
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
        # the paged launch against its twin in float64 on the card and in
        # float32 on the CPU, of the largest |out|
        f64, cpu = _f64_and_cpu(torch, paged, lambda *a: (
            pk.paged_prefix_rank_attn_plain(*a, n_incr=n_incr)),
            (q, pool, pool, kt, vt, plens, kn, vn))
        results["paged_prefix_rank_attn"].setdefault("probes", []).append(
            dict(B=B, rows=rows, Sq=Sq, f64_rel=f64, cpu_rel=cpu))
        new_pairs = B * H * _visible_new(Sq, n_incr)
        held = sum(lens)
        timed = [("prefix_rank_attn",
                  lambda: rk.prefix_rank_attn_split(q, kp, vp, kn, vn,
                                                    n_incr=n_incr),
                  lambda: rk.prefix_rank_attn_plain(
                      q, torch.cat([kp, kn], 2), torch.cat([vp, vn], 2),
                      n_prefix=PSI, n_incr=n_incr),
                  e_d, B * PSI, dense, 0),
                 ("paged_prefix_rank_attn",
                  lambda: pk.paged_prefix_rank_attn(q, pool, pool, kt, vt,
                                                    plens, kn, vn,
                                                    n_incr=n_incr),
                  lambda: pk.paged_prefix_rank_attn_plain(
                      q, pool, pool, kt, vt, plens, kn, vn, n_incr=n_incr),
                  e_p, held, paged, 4 * (2 * B * n_pages + B))]
        if (B, rows, n_incr) == (8, "full", N_INCR):   # row 4 at full rows
            timed.append(("segment_rank_attn", seg_call, lambda: (
                pk.segment_rank_attn_plain(q, pool, pool, kt, vt, ppos, pval,
                                           qpos, kn, vn, n_items=n_items)),
                e_p, held, seg, 4 * (4 * B * n_pages + B * Sq)))
        for name, fn, plain, e, pre_keys, out, tables in timed:
            pairs = new_pairs + H * Sq * pre_keys
            flops = 4 * D * pairs
            nbytes = 4 * (4 * B * H * Sq * D + 2 * pre_keys * H * D) + tables
            t = _rank_times(torch, fn, plain, flops, nbytes, want=out)
            spans = {"spans": [PSI]} if name == "segment_rank_attn" else {}
            results[name]["shapes"].append(dict(
                B=B, P=PSI, n_incr=n_incr, n_items=n_items, rows=rows,
                main=main and name != "segment_rank_attn", max_abs_err=e,
                prefix_tokens=pre_keys, **spans, **t))
            log(f"{name} B={B} P={PSI} ({rows} rows) Sq={Sq}: err {e:.2e} "
                f"kernel {t['ms']:.4f} ms (graph {t['graph_ms']:.4f}) plain "
                f"{t['plain_ms']:.4f} ms bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}), 3xTF32 {t['bound_tf32_ms']:.4f} ms")
        log(f"paged B={B} ({rows} rows) Sq={Sq}: == dense, one-span segment "
            f"== paged, repeat calls and graph replays bit for bit; float64 "
            f"{f64:.2e}, CPU {cpu:.2e} of max |out| (limits {F64_REL}, "
            f"{CPU_REL})")
    unheld_nan_checks(torch, results)
    segment_checks(torch, results, gen, check)
    f32_accuracy(torch, results)
    log("kernels agree with their plain versions; bitwise properties hold")
    bf16_rank_checks(torch, results)


def _floats(args, fn):
    """``args`` with ``fn`` applied to every floating tensor (tables and
    lengths pass as they are)."""
    return {k: fn(v) if hasattr(v, "is_floating_point")
            and v.is_floating_point() else v for k, v in args.items()}


def _bf16_case(torch, results, name, shape, call, plain, args, flops,
               nbytes, f64=True):
    """One kernel at bf16 at one shape: ``call`` / ``plain`` take the
    dict ``args`` (made in float32, rounded to bf16 here).  (a) the bf16
    launch equals the float32 launch on the widened inputs, rounded to
    bf16, bit for bit; (b) against float64 on the widened inputs (the
    twin in float64): that float32 launch within F64_REL of the largest
    |out|, the bf16 output within its rounding plus F64_REL; against the
    bf16 twin within BF16_TWIN of its largest
    |out| (an all-zero output errs by 1); two calls bit for bit; times
    per call and by graph beside the bound at bf16 bytes.  Returns the
    bf16 output."""
    bf = _floats(args, lambda t: t.bfloat16())
    wide = _floats(bf, lambda t: t.float())
    got = call(bf)
    assert got.dtype == torch.bfloat16, f"{name}: bf16 launch wrote {got.dtype}"
    f32 = call(wide)
    assert torch.equal(got, f32.bfloat16()), (
        f"{name} bf16: != the float32 launch on widened inputs, rounded")
    assert torch.equal(call(bf), got), f"{name} bf16: two calls differ"
    want = plain(bf).float()
    top = want.abs().max().item()
    twin = (got.float() - want).abs().max().item() / top
    assert twin <= BF16_TWIN, (
        f"{name} bf16: |kernel - twin| {twin:.2e} of max |twin| over "
        f"{BF16_TWIN}")
    f64_rel = f32_rel = None
    if f64:
        ref64 = plain(_floats(wide, lambda t: t.double()))
        top64 = ref64.abs().max().item()
        f32_rel = (f32.double() - ref64).abs().max().item() / top64
        assert f32_rel <= F64_REL, (
            f"{name} bf16: the float32 launch on widened inputs errs "
            f"{f32_rel:.2e} of max |out| against float64 (limit {F64_REL})")
        err = (got.double() - ref64).abs()
        lim = BF16_OUT * ref64.abs() + (1 + BF16_OUT) * F64_REL * top64
        assert bool((err <= lim).all()), (
            f"{name} bf16: |kernel - float64| over its rounding + {F64_REL} "
            f"of max |out| by {(err - lim).max().item():.3e}")
        f64_rel = err.max().item() / top64
    t = _rank_times(torch, lambda: call(bf), lambda: plain(bf), flops, nbytes,
                    want=got)
    r = dict(shape, dtype="bfloat16", twin_rel=twin, f64_rel=f64_rel,
             f64_rel_before_rounding=f32_rel, **t)
    results[name].setdefault("bf16", []).append(r)
    log(f"{name} bf16 {shape}: == f32 launch on widened inputs (rounded) "
        f"bit for bit; twin {twin:.2e} of max |twin|, float64 {f64_rel} of "
        f"max |out| ({f32_rel} before the rounding); kernel {t['ms']:.4f} ms "
        f"(graph {t['graph_ms']:.4f}) "
        f"plain {t['plain_ms']:.4f} ms bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}), 3xTF32 {t['bound_tf32_ms']:.4f} ms")
    return got


def bf16_rank_checks(torch, results):
    """Rows 1-4 with bf16 inputs at their main shapes (B 8; psi 2048, 16
    incr + 64 items, ragged rows at 64-token pages; the segment pattern),
    rows 2-4 also at full rows (B 8, every row 2048; row 4 one span) and
    at B 1: ``_bf16_case`` each, and the bitwise properties in bf16 --
    paged == dense at equal padded length, one-span segment == paged, and
    a row's bits do not depend on its batch."""
    from repro_torch.kernels import hstu_attn as hk
    from repro_torch.kernels import paged_prefix_attn as pk
    from repro_torch.kernels import prefix_rank_attn as rk
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    act = lambda *shape: torch.nn.functional.silu(
        2 * torch.randn(shape, generator=gen, device=dev))
    B, Sq = 8, N_INCR + N_ITEMS
    case = lambda *a, **k: _bf16_case(torch, results, *a, **k)

    a = dict(q=act(B, H, PSI, D), k=act(B, H, PSI, D), v=act(B, H, PSI, D))
    got = case("hstu_attn", dict(B=B, S=PSI, main=True),
               lambda x: hk.hstu_attn(x["q"], x["k"], x["v"]),
               lambda x: hk.hstu_attn_plain(x["q"], x["k"], x["v"]), a,
               4 * D * B * H * PSI * (PSI + 1) // 2, 2 * 4 * B * H * PSI * D)
    bf = _floats(a, lambda t: t.bfloat16())
    for b in range(B):
        one = hk.hstu_attn(*(bf[k][b:b + 1] for k in "qkv"))
        assert torch.equal(one[0], got[b]), "hstu_attn bf16: batch-dependent row"

    # prefix_rank_attn and paged: one pool of distinct, shuffled K and V
    # pages; the ragged batch (main), the batch at full rows, one hit at
    # 2048 psi; the dense prefix gathered from it
    n_pages = PSI // PAGE
    for B, rows in ((8, "ragged"), (8, "full"), (1, "full")):
        main = rows == "ragged"
        n_pool = 2 * B * n_pages
        pool = act(n_pool + 1, PAGE, H, D)
        pool[n_pool] = 0
        perm = torch.randperm(n_pool, generator=gen, device=dev).int()
        kt = torch.full((B, n_pages), n_pool, dtype=torch.int32, device=dev)
        vt = kt.clone()
        lens = RAGGED[:B] if main else [PSI] * B
        for b, ln in enumerate(lens):
            used = -(-ln // PAGE)
            kt[b, :used] = perm[2 * b * n_pages:2 * b * n_pages + used]
            vt[b, :used] = perm[(2 * b + 1) * n_pages:
                                (2 * b + 1) * n_pages + used]
        plens = torch.tensor(lens, dtype=torch.int32, device=dev)
        new = dict(q=act(B, H, Sq, D), kn=act(B, H, Sq, D), vn=act(B, H, Sq, D))
        pb = pool.bfloat16()
        dense_args = dict(new, kp=ref.gather_pages(pb, kt, plens).float(),
                          vp=ref.gather_pages(pb, vt, plens).float())
        dense_call = lambda x: rk.prefix_rank_attn_split(
            x["q"], x["kp"], x["vp"], x["kn"], x["vn"], n_incr=N_INCR)
        dense_plain = lambda x: rk.prefix_rank_attn_plain(
            x["q"], torch.cat([x["kp"], x["kn"]], 2),
            torch.cat([x["vp"], x["vn"]], 2), n_prefix=PSI, n_incr=N_INCR)
        shape = dict(B=B, P=PSI, n_incr=N_INCR, n_items=N_ITEMS, rows=rows,
                     main=main)
        pairs = B * H * _visible_new(Sq, N_INCR) + H * Sq * B * PSI
        dense = case("prefix_rank_attn", shape, dense_call, dense_plain,
                     dense_args, 4 * D * pairs,
                     2 * (4 * B * H * Sq * D + 2 * B * PSI * H * D))
        paged_args = dict(new, pool=pool)
        paged_call = lambda x: pk.paged_prefix_rank_attn(
            x["q"], x["pool"], x["pool"], kt, vt, plens, x["kn"], x["vn"],
            n_incr=N_INCR)
        paged_plain = lambda x: pk.paged_prefix_rank_attn_plain(
            x["q"], x["pool"], x["pool"], kt, vt, plens, x["kn"], x["vn"],
            n_incr=N_INCR)
        held = sum(lens)
        pairs = B * H * _visible_new(Sq, N_INCR) + H * Sq * held
        paged = case("paged_prefix_rank_attn", dict(shape, prefix_tokens=held),
                     paged_call, paged_plain, paged_args, 4 * D * pairs,
                     2 * (4 * B * H * Sq * D + 2 * held * H * D)
                     + 4 * (2 * kt.numel() + B))
        assert torch.equal(paged, dense), "bf16: paged != dense bitwise"
        ppos = (torch.arange(n_pages, dtype=torch.int32, device=dev) * PAGE
                ).expand(B, n_pages).contiguous()
        pval = (plens[:, None] - ppos).clamp(0, PAGE).int()
        qpos = (PSI + torch.arange(Sq, dtype=torch.int32, device=dev)
                ).expand(B, Sq)
        span_call = lambda x: pk.segment_rank_attn(
            x["q"], x["pool"], x["pool"], kt, vt, ppos, pval, qpos, x["kn"],
            x["vn"], n_items=N_ITEMS)
        nb = _floats(new, lambda t: t.bfloat16())
        if (B, rows) == (8, "full"):     # row 4 at full rows: one span each
            span_plain = lambda x: pk.segment_rank_attn_plain(
                x["q"], x["pool"], x["pool"], kt, vt, ppos, pval, qpos,
                x["kn"], x["vn"], n_items=N_ITEMS)
            one_span = case("segment_rank_attn", dict(
                shape, main=False, spans=[PSI]), span_call, span_plain,
                paged_args, 4 * D * pairs,
                2 * (4 * B * H * Sq * D + 2 * held * H * D)
                + 4 * (4 * kt.numel() + B * Sq))
        else:
            one_span = span_call(dict(nb, pool=pb))
        assert torch.equal(one_span, paged), \
            "bf16: one-span segment != paged bitwise"
        db = _floats(dense_args, lambda t: t.bfloat16())
        for b in range(B if B > 1 else 0):
            s = slice(b, b + 1)
            one_d = rk.prefix_rank_attn_split(db["q"][s], db["kp"][s],
                                              db["vp"][s], db["kn"][s],
                                              db["vn"][s], n_incr=N_INCR)
            one_p = pk.paged_prefix_rank_attn(nb["q"][s], pb, pb, kt[s],
                                              vt[s], plens[s], nb["kn"][s],
                                              nb["vn"][s], n_incr=N_INCR)
            assert torch.equal(one_d[0], dense[b]), \
                "bf16 dense: batch-dependent row"
            assert torch.equal(one_p[0], paged[b]), \
                "bf16 paged: batch-dependent row"

    # segment_rank_attn: the segment pattern in every row, B 8 and 1
    for B in (8, 1):
        seg = _segment_inputs(torch, gen, B)
        n_items = seg.pop("n_items")
        seg_call = lambda x: pk.segment_rank_attn(**x, n_items=n_items)
        seg_plain = lambda x: pk.segment_rank_attn_plain(**x, n_items=n_items)
        kpos = ref.span_key_positions(seg["page_pos"], seg["page_valid"], PAGE)
        Sq = seg["q"].shape[2]
        cached = (kpos[:, None, :] <= seg["q_pos"][:, :, None]).sum().item()
        held = (kpos != ref.HIDDEN).sum().item()
        pairs = H * (cached + B * _visible_new(Sq, Sq - N_ITEMS))
        got = case("segment_rank_attn", dict(
            B=B, P=PSI, n_incr=Sq - N_ITEMS, n_items=N_ITEMS, rows="spans",
            spans=[n for kind, n in SEG_PATTERN if kind == "c"], main=B == 8),
            seg_call, seg_plain, seg, 4 * D * pairs,
            2 * (4 * B * H * Sq * D + 2 * held * H * D)
            + 4 * (4 * seg["k_table"].numel() + B * Sq))
        sb = _floats(seg, lambda t: t.bfloat16())
        for b in range(B if B > 1 else 0):
            one = pk.segment_rank_attn(**{
                k: v[b:b + 1] if k not in ("k_pages", "v_pages") else v
                for k, v in sb.items()}, n_items=n_items)
            assert torch.equal(one[0], got[b]), \
                "bf16 segment: batch-dependent row"
    log("bf16 rank kernels: each == the float32 launch on widened inputs "
        "(rounded) bit for bit; paged == dense, one-span segment == paged, "
        "rows independent of the batch, in bf16")


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


def _segment_inputs(torch, gen, B, page=PAGE, pattern=SEG_PATTERN, pad=0):
    """``pattern`` (SEG_PATTERN) in every row of B, at ``page``-token
    pages of one pool whose K and V pages are distinct and shuffled (the
    null page last, zero), the table ``pad`` null slots wider.  Values
    are SiLU-shaped, silu(2 N(0, 1)), as the model's own q, k and v are
    (HSTU passes them through SiLU), so the cached spans move the output
    well past the limit; the tail of a partly held page is data too,
    which the kernel must not read."""
    dev = torch.device("cuda")
    act = lambda *shape: torch.nn.functional.silu(
        2 * torch.randn(shape, generator=gen, device=dev))
    spans, fresh, pos = [], [], 0
    for kind, n in pattern:
        if kind == "c":
            spans.append((pos, n))
        else:
            fresh.extend(range(pos, pos + n))
        pos += n
    pp, pv = [], []
    for start, n in spans:
        for lo in range(0, n, page):
            pp.append(start + lo)
            pv.append(min(page, n - lo))
    n_held, Sq = len(pp), len(fresh)
    n_pool = 2 * B * n_held
    pool = act(n_pool + 1, page, H, D)
    pool[n_pool] = 0
    perm = torch.randperm(n_pool, generator=gen, device=dev).int()
    null = torch.full((B, pad), n_pool, dtype=torch.int32, device=dev)
    rows = lambda a: torch.tensor([a] * B, dtype=torch.int32, device=dev)
    return dict(q=act(B, H, Sq, D), k_pages=pool, v_pages=pool,
                k_table=torch.cat([perm[:B * n_held].view(B, n_held), null], 1),
                v_table=torch.cat([perm[B * n_held:].view(B, n_held), null], 1),
                page_pos=rows(pp + [0] * pad), page_valid=rows(pv + [0] * pad),
                q_pos=rows(fresh),
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
                        flops, nbytes, want=got)
        assert torch.equal(pk.segment_rank_attn(**a), got), \
            f"{name}: two calls differ"
        f64, cpu = _f64_and_cpu(torch, got, lambda *x: (
            pk.segment_rank_attn_plain(*x, n_items=N_ITEMS)), tuple(
            a[k] for k in ("q", "k_pages", "v_pages", "k_table", "v_table",
                           "page_pos", "page_valid", "q_pos", "k_new",
                           "v_new")))
        results[name].setdefault("probes", []).append(
            dict(B=B, rows="spans", Sq=Sq, f64_rel=f64, cpu_rel=cpu))
        results[name]["shapes"].append(dict(
            B=B, P=PSI, n_incr=Sq - N_ITEMS, n_items=N_ITEMS,
            spans=[n for kind, n in SEG_PATTERN if kind == "c"],
            main=B == 8, max_abs_err=e, zero_fails=zero,
            wrong_mask_margins=margins, f64_rel=f64, cpu_rel=cpu, **t))
        log(f"{name} B={B} spans {results[name]['shapes'][-1]['spans']} "
            f"Sq={Sq}: err {e:.2e} kernel {t['ms']:.4f} ms (graph "
            f"{t['graph_ms']:.4f}) plain {t['plain_ms']:.4f} ms bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), 3xTF32 "
            f"{t['bound_tf32_ms']:.4f} ms; float64 {f64:.2e}, CPU {cpu:.2e} "
            f"of max |out|; all-zero fails {zero:.3f}, "
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


_SEG_MUST = ("hstu_attn", "segment_rank_attn")
# (mode, flags, kernels that must launch, kernels that must not)
SERVE_MODES = (
    ("live", [], ("hstu_attn", "prefix_rank_attn"), ()),
    ("batched", ["--batched"], ("hstu_attn", "prefix_rank_attn"), ()),
    ("batched-device-pool", ["--batched", "--device-pool"],
     ("hstu_attn", "paged_prefix_rank_attn"), ("segment_rank_attn",)),
    ("segments-device-pool", ["--segments", "--device-pool"], _SEG_MUST,
     ("paged_prefix_rank_attn",)),
    ("batched-segments-device-pool",
     ["--batched", "--segments", "--device-pool"], _SEG_MUST,
     ("paged_prefix_rank_attn",)))


def serve_phase(torch, results, requests, tag="serve", store="_serve"):
    """The five serve modes at full width, each kernel of a mode launched
    (``tag`` names the run in the log; ``store`` where it is kept)."""
    for mode, flags, must, must_not in SERVE_MODES:
        r = serve_run(torch, flags, requests)
        hits, counts = r["hits"], r["launches"]
        log(f"{tag} {mode}: {r['wall_s']:.1f} s hits={hits} launches={counts} "
            f"rank p50 {r['p50_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms, "
            f"graphs {r['graphs']}")
        log(f"{tag} {mode}: launches by batch size {r['by_batch']}")
        assert r["graphs"] is not None, f"{mode}: served without graphs"
        assert hits.get("hbm_hit", 0) > 0, f"{mode}: no hbm_hit in {hits}"
        for n in must:
            assert counts[n] > 0, f"{mode}: {n} never launched"
        for n in must_not:
            assert counts[n] == 0, f"{mode}: {n} launched {counts[n]} times"
        for n, c in counts.items():
            results[n]["launches"] += c
        results.setdefault(store, {})[mode] = r
    for n in RANK_COUNTERS:
        assert results[n]["launches"] > 0, f"{n} never launched on the main path"


# --- phase 5a: the HSTU relay at bf16 ---------------------------------------------

BF16_RELAY_REL = BF16_OUT    # |relay - full| at bf16, of the largest |score|
# card vs the port on the CPU at bf16, of the largest |score|: the card's
# kernels round once from float32, the CPU twins round logits and scores
# to bf16 (the reference's oracles) -- bf16 ulps apart at every layer
BF16_CPU_REL = 2 ** -4


def bf16_phase(torch, results, requests):
    """A bf16 ``hstu-gr`` (``dataclasses.replace(cfg, dtype="bfloat16")``)
    at full width, random weights from a seed: the five serve modes of
    phase 4 with CUDA graphs, every counter zeroed just before and read
    just after each (rows 1-4 at bf16: each launched where its mode
    reaches it); psi's bytes per user; the relay-vs-full contract and
    card vs the port on the CPU, at stated bf16 limits."""
    import dataclasses

    import numpy as np
    from repro_torch.launch import serve
    from repro_torch.models import build_model, get_config

    bf16 = lambda cfg: dataclasses.replace(cfg, dtype="bfloat16")
    get = serve.get_config
    serve.get_config = lambda arch, smoke=False: bf16(get(arch, smoke=smoke))
    before = {n: results[n]["launches"] for n in RANK_COUNTERS}
    try:
        serve_phase(torch, results, requests, tag="bf16 serve", store="_bf16")
    finally:
        serve.get_config = get
    for n in RANK_COUNTERS:
        results[n]["launches_bf16"] = (results[n].get("launches_bf16", 0)
                                       + results[n]["launches"] - before[n])
        assert results[n]["launches_bf16"] > 0, f"{n}: no bf16 launch"

    cfg = bf16(get_config("hstu-gr"))
    gpu = build_model(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab, (1, PSI))
    incr = rng.integers(0, cfg.vocab, (1, N_INCR))
    items = rng.integers(0, cfg.vocab, (1, N_ITEMS))
    on = lambda a, m: torch.as_tensor(a, device=m.device)
    _, psi = gpu.prefill({"tokens": on(prefix, gpu)})
    psi_bytes = _nbytes(psi)
    assert psi[0].dtype == torch.bfloat16
    assert psi_bytes == gpu.kv_bytes(PSI), (psi_bytes, gpu.kv_bytes(PSI))
    relay = gpu.rank_with_cache(psi, on(incr, gpu), on(items, gpu))
    full = gpu.full_rank(on(prefix, gpu), on(incr, gpu), on(items, gpu))
    assert relay.dtype == torch.bfloat16 and torch.isfinite(relay).all()
    top = full.float().abs().max().item()
    eps = (relay.float() - full.float()).abs().max().item() / top
    assert eps <= BF16_RELAY_REL, f"bf16 |relay - full| {eps:.3e} of max |score|"
    want = cpu.full_rank(on(prefix, cpu), on(incr, cpu), on(items, cpu)).float()
    scale = max(want.abs().max().item(), 1.0)
    diff = (full.float().cpu() - want).abs().max().item() / scale
    assert diff <= BF16_CPU_REL, (
        f"bf16 card vs CPU scores differ by {diff:.3e} of max |score|")
    f32 = results.get("_relay", {})
    log(f"bf16 relay ({cfg.n_layers} layers, d {cfg.d_model}): psi "
        f"{psi_bytes / 1e6:.1f} MB a user at {PSI} tokens (float32: "
        f"{2 * psi_bytes / 1e6:.1f} MB); |relay - full| {eps:.2e} of max "
        f"|score| (limit {BF16_RELAY_REL}); card vs CPU {diff:.3e} of max "
        f"|score| (limit {BF16_CPU_REL}); the f32 relay phase: {f32}")
    results["_bf16_relay"] = dict(psi_bytes=psi_bytes, psi_tokens=PSI,
                                  eps=eps, card_vs_cpu=diff, max_score=top)


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


def _ssd_bf16_inputs(torch, gen, B, nc, Q, H=64, P=64, N=64):
    """The SSD stages' inputs as the bf16 model hands them over: x, B, C
    strided bf16 views of one (B, L, H P + 2 N) xBC (no copy); cum and
    dt float32 as in ``_ssd_inputs``."""
    dev = torch.device("cuda")
    L = nc * Q
    xBC = torch.randn((B, L, H * P + 2 * N), generator=gen,
                      device=dev).bfloat16()
    xc = xBC[..., :H * P].view(B, nc, Q, H, P)
    Bc = xBC[..., H * P:H * P + N].reshape(B, nc, Q, N)
    Cc = xBC[..., H * P + N:].reshape(B, nc, Q, N)
    dtc = torch.nn.functional.softplus(
        torch.randn((B, nc, Q, H), generator=gen, device=dev))
    A = -torch.exp(0.5 * torch.randn(H, generator=gen, device=dev))
    return Cc, Bc, xc, torch.cumsum(dtc * A, dim=2), dtc


def ssd_bf16_checks(torch, results, gen):
    """Rows 6-7 on bf16 x, B, C (strided views of one xBC, as the model
    hands them over) at the prefill shape and a ragged chunk: (a) the
    intra launch writing float32 (the model's) equals the float32 launch
    on widened inputs bit for bit, the one writing bf16 (the Pallas
    kernel's default) equals it rounded, the state equals the float32
    state launch bit for bit; the twins (which widen too) within the
    float32 tolerance; (b) against float64 on the widened inputs within
    F64_REL of the largest |out| (at the prefill shape); two calls and
    the rows of the batch bit for bit; times beside the bound at bf16
    bytes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as sk

    f32 = torch.float32
    for B, nc, Q in ((HYB_B, HYB_S // 128, 128), (HYB_B, 1, 100)):
        Cc, Bc, xc, cum, dtc = _ssd_bf16_inputs(torch, gen, B, nc, Q)
        H, P, N = xc.shape[3], xc.shape[4], Bc.shape[3]
        main = (B, nc * Q) == (HYB_B, HYB_S)
        shape = dict(B=B, L=nc * Q, Q=Q, H=H, P=P, N=N, main=main,
                     dtype="bfloat16")
        wC, wB, wx = (t.float() for t in (Cc, Bc, xc))
        y = sk.ssd_chunk_intra(Cc, Bc, xc, cum, dtc, out_dtype=f32)
        assert torch.equal(y, sk.ssd_chunk_intra(wC, wB, wx, cum, dtc)), (
            "ssd_chunk_intra bf16: != the float32 launch on widened inputs")
        yb = sk.ssd_chunk_intra(Cc, Bc, xc, cum, dtc)
        assert yb.dtype == torch.bfloat16 and torch.equal(yb, y.bfloat16()), (
            "ssd_chunk_intra bf16 out: != the float32 launch, rounded")
        assert torch.equal(sk.ssd_chunk_intra(Cc, Bc, xc, cum, dtc,
                                              out_dtype=f32), y), \
            "ssd_chunk_intra bf16: two calls differ"
        for b in range(B):
            s = slice(b, b + 1)
            one = sk.ssd_chunk_intra(Cc[s], Bc[s], xc[s], cum[s], dtc[s],
                                     out_dtype=f32)
            assert torch.equal(one[0], y[b]), \
                "ssd_chunk_intra bf16: batch-dependent row"
        st = sk.ssd_chunk_state(Bc, xc, cum, dtc)
        assert torch.equal(st, sk.ssd_chunk_state(wB, wx, cum, dtc)), (
            "ssd_chunk_state bf16: != the float32 launch on widened inputs")
        assert torch.equal(sk.ssd_chunk_state(Bc, xc, cum, dtc), st), \
            "ssd_chunk_state bf16: two calls differ"
        e_i = _check(results, "ssd_chunk_intra", y,
                     sk.ssd_chunk_intra_ref(Cc, Bc, xc, cum, dtc, f32))
        e_s = _check(results, "ssd_chunk_state", st,
                     sk.ssd_chunk_state_ref(Bc, xc, cum, dtc))
        rel = {}
        if main:
            for name, got, want in (
                    ("ssd_chunk_intra", y,
                     ref.ssd_chunk_intra_f64(Cc, Bc, xc, cum, dtc)),
                    ("ssd_chunk_state", st, _state_f64(Bc, xc, cum, dtc))):
                rel[name] = ((got.double() - want).abs().max().item()
                             / want.abs().max().item())
                assert rel[name] <= F64_REL, (
                    f"{name} bf16: |kernel - float64| {rel[name]:.2e} of max "
                    f"|out| over {F64_REL}")
        kept = Q * (Q + 1) // 2
        for name, fn, plain, e, flops, nbytes in (
                ("ssd_chunk_intra",
                 lambda: sk.ssd_chunk_intra(Cc, Bc, xc, cum, dtc, out_dtype=f32),
                 lambda: sk.ssd_chunk_intra_ref(Cc, Bc, xc, cum, dtc, f32), e_i,
                 B * nc * (2 * Q * Q * N + H * kept * (2 * P + 4)),
                 2 * (2 * B * nc * Q * N + B * nc * Q * H * P)
                 + 4 * (B * nc * Q * H * P + 2 * B * nc * Q * H)),
                ("ssd_chunk_state", lambda: sk.ssd_chunk_state(Bc, xc, cum, dtc),
                 lambda: sk.ssd_chunk_state_ref(Bc, xc, cum, dtc), e_s,
                 B * nc * H * (2 * Q * N * P + 3 * Q),
                 2 * (B * nc * Q * N + B * nc * Q * H * P)
                 + 4 * (2 * B * nc * Q * H + B * nc * H * N * P))):
            bound_ms, by = _bound(flops, nbytes)
            t = dict(ms=_time_ms(torch, fn), graph_ms=_graph_ms(torch, fn),
                     plain_ms=_time_ms(torch, plain, 5), library_ms=None,
                     bound_ms=bound_ms, bound_by=by,
                     bound_tf32_ms=(_bound_tf32(flops, nbytes)
                                    if name == "ssd_chunk_intra" else None))
            results[name].setdefault("bf16", []).append(dict(
                shape, max_abs_err=e, f64_rel=rel.get(name), **t))
            log(f"{name} bf16 {shape}: == f32 launch on widened inputs bit for "
                f"bit; err vs twin {e:.2e}, float64 {rel.get(name)} of max "
                f"|out|; kernel {t['ms']:.4f} ms (graph {t['graph_ms']:.4f}) "
                f"plain {t['plain_ms']:.4f} ms bound {bound_ms:.4f} ms ({by})")
        del Cc, Bc, xc, y, yb, st, wC, wB, wx


def _ssd_spy(torch):
    """Record the types x, B and C reach each SSD launch in: returns
    (the list of (kind, C, B, x) types, restore)."""
    from repro_torch.kernels import cuda_lib
    launch, seen = cuda_lib.ssd_chunk, []

    def spy(kind, Cc, Bc, xc, *a, **k):
        seen.append((kind, None if Cc is None else Cc.dtype, Bc.dtype,
                     xc.dtype))
        return launch(kind, Cc, Bc, xc, *a, **k)

    cuda_lib.ssd_chunk = spy
    return seen, lambda: setattr(cuda_lib, "ssd_chunk", launch)


def _assert_bf16_launches(torch, seen, where):
    """Every SSD launch of ``seen`` took bf16 x, B and C: no float32 copy
    of x was made on the way."""
    assert seen, f"{where}: no SSD launch"
    wrong = [s for s in seen if any(t not in (None, torch.bfloat16)
                                    for t in s[1:])]
    assert not wrong, f"{where}: SSD launches took {set(wrong)}"


def ssd_route_check(torch, model, cfg, B, S, grad):
    """Layer 0's Mamba2 mixer of ``model`` on a bf16 input (B, S, d) -- the
    embedded prompts -- with x, B and C handed to the SSD kernels in bf16,
    against the route that hands each kernel float32 copies of them: the
    output and both states (and, with ``grad``, the gradients of the
    input and of every mixer weight) equal bit for bit.  Returns the
    launches' types."""
    from repro_torch.kernels import ssd_chunk as sk
    from repro_torch.models.ssm import mamba2_forward

    prefix = "sections.mixer."
    params = {k[len(prefix):]: v.detach()[0, 0]
              for k, v in model.named_parameters() if k.startswith(prefix)}
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen).cuda()
    u0 = model.tok.detach()[toks]
    g = torch.randn((B, S, cfg.d_model), generator=gen).cuda()

    def run():
        u = u0.clone().requires_grad_(grad)
        p = {k: v.clone().requires_grad_(grad) for k, v in params.items()}
        with torch.set_grad_enabled(grad):
            y, (ssm_state, conv_state) = mamba2_forward(p, u, cfg)
            if grad:
                (y.float() * g).sum().backward()
        outs = [y, ssm_state, conv_state]
        if grad:
            outs += [u.grad] + [p[k].grad for k in sorted(p)]
        return outs

    seen, restore = _ssd_spy(torch)
    try:
        new = run()
    finally:
        restore()
    intra, state = sk.ssd_chunk_intra, sk.ssd_chunk_state
    sk.ssd_chunk_intra = lambda C, Bm, x, cum, dt, out_dtype=None: intra(
        C.float(), Bm.float(), x.float(), cum, dt, out_dtype)
    sk.ssd_chunk_state = lambda Bm, x, cum, dt: state(Bm.float(), x.float(),
                                                      cum, dt)
    try:
        old = run()
    finally:
        sk.ssd_chunk_intra, sk.ssd_chunk_state = intra, state
    for i, (a, b) in enumerate(zip(new, old)):
        assert a.dtype == b.dtype and torch.equal(a, b), (
            f"layer 0 at {B} x {S}: output {i} differs from the float32-copy "
            f"route (max {(a.float() - b.float()).abs().max().item():.3e})")
    return seen


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
    ssd_bf16_checks(torch, results, gen)
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
    seen, restore = _ssd_spy(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        logits, cache = prefill({"tokens": prompts})
        torch.cuda.synchronize()
    finally:
        restore()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    c_pre = counters()
    _assert_bf16_launches(torch, seen, "zamba2 prefill")
    route = ssd_route_check(torch, model, cfg, HYB_B, HYB_S, grad=False)
    _assert_bf16_launches(torch, route, "zamba2 layer 0")
    log(f"prefill: all {len(seen)} SSD launches took bf16 x, B, C (no "
        f"float32 copy); layer 0 at {HYB_B} x {HYB_S} equals the float32-copy "
        f"route bit for bit (output and states)")
    peak_pre = torch.cuda.max_memory_allocated()
    live_pre = [_nbytes(list(model.parameters())),
                _nbytes({"tokens": prompts})]
    log(f"prefill {HYB_B} x {HYB_S}: {prefill_ms:.1f} ms, launches {c_pre}, "
        f"peak {peak_pre / 2**30:.1f} GiB")
    assert c_pre == {"ssd_chunk_intra": cfg.n_layers,
                     "ssd_chunk_state": cfg.n_layers, "decode_attn": 0}, c_pre
    for name in ("ssd_chunk_intra", "ssd_chunk_state"):
        results[name]["launches_bf16"] = (results[name].get("launches_bf16", 0)
                                          + c_pre[name])
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
        prefill_peak_bytes=peak_pre, live_args_prefill=live_pre,
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
    live_args = [_nbytes(step.params), _nbytes(state), _nbytes(batches[0])]
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
                      live_args=live_args,
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
           ("deepseek_moe_16b", 2, 2048, 32),
           ("internvl2_2b", 8, 2048, 8))
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
    decode_lse_checks(torch, results)


def decode_lse_checks(torch, results):
    """Row 5's log-sum-exp (``decode_attn(..., lse=True)``, written by
    the same launch): at the hybrid's main shape (B 2, H = KV = 32, S
    8192, D 64, bf16), at ``qwen3_4b``'s heads over one rank's share of
    the kv_seq ring (32 q / 8 kv, D 128, 16384 slots, bf16) and in
    float32 over a ragged ring: the lse within LSE_TOL of its twin's
    (``torch.logsumexp``) and of float64's, ``out`` the same bits with
    and without it; the ring cut into DIST_W parts, launched once a part
    on one card and merged by the parts' lse (``layers.merge_ring``'s
    arithmetic, no mesh), against one launch over the whole ring
    (float32 within 1e-5 of the largest |out|, bf16 within BF16_REL);
    the call timed with and without the lse in turns.  Comparisons,
    outside the main path's counts."""
    from repro_torch.kernels import decode_attn as dk

    gen = torch.Generator(device="cuda").manual_seed(13)
    out = results["decode_attn"].setdefault("lse", [])
    for tag, B, H, KV, S, D, dtype in (
            ("zamba2 decode (main)", HYB_B, 32, 32, HYB_S, 64, torch.bfloat16),
            ("qwen3_4b kv_seq shard", 1, 32, 8, KV_SEQ_RING // DIST_W, 128,
             torch.bfloat16),
            ("float32 ragged", HYB_B, 32, 8, 4096 + 37, 64, torch.float32)):
        q = torch.randn((B, H, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, S, KV, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, S, KV, D), generator=gen, device="cuda").to(dtype)
        o, lse = dk.decode_attn(q, k, v, lse=True)
        assert torch.equal(o, dk.decode_attn(q, k, v)), \
            f"decode_attn {tag}: out differs when the lse is asked for"
        _, twin = dk.decode_attn_plain(q, k, v, lse=True)
        l64 = torch.cat([dk.decode_attn_plain(*(t[b:b + 1].double()
                                                for t in (q, k, v)),
                                              lse=True)[1]
                         for b in range(B)])
        e_twin = (lse - twin).abs().max().item()
        e_f64 = (lse.double() - l64).abs().max().item()
        assert max(e_twin, e_f64) <= LSE_TOL, (tag, e_twin, e_f64)
        cut = [i * S // DIST_W for i in range(DIST_W + 1)]
        cut[1:-1] = [c - c % 8 for c in cut[1:-1]]       # 16-byte rows
        parts = [dk.decode_attn(q, k[:, a:b], v[:, a:b], lse=True)
                 for a, b in zip(cut[:-1], cut[1:])]
        pl = torch.stack([p[1] for p in parts])
        wgt = torch.exp(pl - pl.amax(0))
        merged = (torch.stack([p[0].float() for p in parts])
                  * wgt[..., None]).sum(0) / wgt.sum(0)[..., None]
        scale = o.float().abs().max().item()
        lim = (1e-5 if dtype == torch.float32 else BF16_REL) * scale
        e_merge = (merged - o.float()).abs().max().item()
        assert e_merge <= lim, (tag, e_merge, lim)
        runs = {"lse": [], "out": []}
        for who in ("out", "lse", "lse", "out") * 2:
            runs[who].append(_time_ms(
                torch, (lambda: dk.decode_attn(q, k, v, lse=True))
                if who == "lse" else (lambda: dk.decode_attn(q, k, v))))
        row = dict(case=tag, B=B, H=H, KV=KV, S=S, D=D, dtype=str(dtype),
                   lse_twin_err=e_twin, lse_f64_err=e_f64,
                   merge_err=e_merge, merge_lim=lim,
                   ms=statistics.median(runs["out"]),
                   ms_lse=statistics.median(runs["lse"]),
                   graph_ms=_graph_ms(torch, lambda: dk.decode_attn(q, k, v)),
                   graph_ms_lse=_graph_ms(torch, lambda: dk.decode_attn(
                       q, k, v, lse=True)), runs=runs)
        out.append(row)
        log(f"decode_attn lse, {tag} (B {B}, {H} q / {KV} kv, S {S}, D {D}, "
            f"{str(dtype)[6:]}): |lse - twin| {e_twin:.2e}, |lse - float64| "
            f"{e_f64:.2e}; out the same bits with it; {DIST_W} parts merged "
            f"by their lse {e_merge:.2e} of one launch (limit {lim:.2e}); "
            f"{row['ms']:.4f} ms without, {row['ms_lse']:.4f} ms with (a "
            f"call, in turns); by graph replay {row['graph_ms']:.4f} / "
            f"{row['graph_ms_lse']:.4f} ms")


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
    params = list(model.parameters())
    live_prefill = [_nbytes(params), _nbytes(batch)]
    live_decode = [_nbytes(params), _nbytes(cache),
                   _nbytes({"token": tok0, "pos": pos})]

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
               live_args_prefill=live_prefill, live_args_decode=live_decode,
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
    decode steps), deepseek_moe_16b at full width cut to 2 layers (2 x
    2048, 32 steps), internvl2_2b at full width cut to 8 layers (2 x
    (256 + 2048), 8 steps), then card against CPU for qwen3_4b and
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


# --- phase 11: LM training (every family; the SSD kernels' gradients) ---------------

SSD_GRAD_REL = 1e-5     # SSD Functions' float32 gradients vs float64, of each input's largest |g|
LMT_B, LMT_S = 2, 4096  # zamba2_1p2b: train_4k's sequence, its batch of 256 cut to 2
LMT_WARM, LMT_STEPS = 2, 10              # warm-up and timed AdamW steps
LMT_PEAK_GIB = 75.0                      # max_memory_allocated of the timed steps
LMT_CPU_B, LMT_CPU_S, LMT_CPU_L = 1, 256, 2   # card vs CPU: one section of 2
LMT_LOSS_REL, LMT_GRAD_REL = 1e-5, 1e-4  # ... the loss relative; each leaf of its largest |g|
# ... at the reference init: the shared attention's wq / wk take their
# fan-in from the head count (32), so q and k are sqrt(2048 / 32) = 8
# times a unit scale and its softmax is near one-hot; a float32
# reordering moved wk's gradient by 2.65e-4 of its largest |g| (H100).
# Held at this limit, and at LMT_GRAD_REL with wq / wk at fan-in d
LMT_GRAD_REL_INIT = 1e-3
# the other families at full width, cut in depth only: (arch, layers kept,
# B, S; a VLM's 256 frontend embeddings and the enc-dec's 1536 frames
# besides, every layer of its encoder kept as of its decoder, steps)
LMT_RUNS = (("qwen3_4b", 4, 2, 4096, 4),
            ("deepseek_moe_16b", 2, 2, 2048, 4),
            ("internvl2_2b", 4, 2, 2048, 4),
            ("rwkv6_1p6b", 2, 2, 512, 3),
            ("seamless_m4t_large_v2", 2, 2, 512, 4),
            ("ssm_mamba2", 2, 2, 1024, 4))
# AdamW as the launcher's, but with the global-norm clip off: at the
# reference init the embedding (drawn at 1 / sqrt(vocab)) reaches ln1
# ~180x amplified, so its gradient is ~90% of a 7.1e5 norm; clipped to 1,
# every unembed element's update then falls below eps (1e-8) and the loss
# does not move in 12 steps (10.8403 -> 10.8414 on the first batch, H100).
# Each step logs the share of the norm and the unembed's frozen share.
LMT_ADAMW = dict(lr=3e-4, grad_clip=float("inf"))
LMT_PARTS = ("GEMMs", "SSD kernels", "SSD backward", "attention",
             "unembed/CE", "layer-slice grads", "AdamW", "elementwise")
LMT_GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
                "aten::matmul", "aten::linear")
LMT_EVAL = "autograd::engine::evaluate_function: "


def _state_f64(Bc, xc, cum, dtc):
    """``ssd_chunk_state_ref``'s einsum, in float64 (the float64 twin of
    ``ssd_chunk_intra`` is ``kernels.ref.ssd_chunk_intra_f64``)."""
    import torch
    return torch.einsum("bcqn,bcqh,bcqhp->bchnp", Bc.double(),
                        (cum[:, :, -1:] - cum).double().exp() * dtc.double(),
                        xc.double())


def ssd_grad_checks(torch, results):
    """The SSD Functions (the kernel forward, the float32 backward) against
    float64 autograd of the twins' einsums, at the zamba2 train step's
    shape per layer (B 2, L 4096, Q 128, H = P = N = 64) and a ragged
    one (3 chunks of 100): every input's gradient within SSD_GRAD_REL of
    its largest |g|; each backward timed beside its kernel's forward
    and its bound.  These launches are comparisons, outside the main
    path's counts."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as sk
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = results.setdefault("_lmtrain", {}).setdefault("ssd_grad", {})
    for B, nc, Q in ((LMT_B, LMT_S // 128, 128), (LMT_B, 3, 100)):
        ins = _ssd_inputs(torch, gen, B, nc, Q)
        H, P, N = ins[2].shape[3], ins[2].shape[4], ins[1].shape[3]
        dy = torch.randn((B, nc, Q, H, P), generator=gen, device="cuda")
        dS = torch.randn((B, nc, H, N, P), generator=gen, device="cuda")
        kept = Q * (Q + 1) // 2
        for name, fn, f64, bwd, names, args, dout, flops, nbytes in (
                ("ssd_chunk_intra", sk.ssd_chunk_intra,
                 ref.ssd_chunk_intra_f64, sk.ssd_chunk_intra_backward,
                 "C B x cum dt", ins, dy,
                 # s = C B^T, G = dy x^T, dx = M^T dy, dC and dB; ~12
                 # elementwise operations per kept (q, t, h)
                 B * nc * (3 * 2 * Q * Q * N + H * kept * (4 * P + 12)),
                 4 * (2 * 2 * B * nc * Q * N + 3 * B * nc * Q * H * P
                      + 4 * B * nc * Q * H)),
                ("ssd_chunk_state", sk.ssd_chunk_state, _state_f64,
                 sk.ssd_chunk_state_backward, "B x cum dt", ins[1:], dS,
                 # B dS, dB and x . (B dS), ~6 per (t, h)
                 B * nc * (2 * 2 * Q * N * H * P + 2 * Q * H * P
                           + 6 * Q * H),
                 4 * (2 * B * nc * Q * N + 2 * B * nc * Q * H * P
                      + 4 * B * nc * Q * H + B * nc * H * N * P))):
            f32 = [t.detach().clone().requires_grad_(True) for t in args]
            y = fn(*f32)
            assert type(y.grad_fn).__name__.startswith("SSDChunk"), \
                f"{name}: no Function on a CUDA tensor"
            y.backward(dout)
            d64 = [t.detach().double().requires_grad_(True) for t in args]
            f64(*d64).backward(dout.double())
            rels = {}
            for n, a, b in zip(names.split(), f32, d64):
                assert torch.isfinite(a.grad).all(), f"{name} d{n}: non-finite"
                top = b.grad.abs().max().item()
                err = (a.grad.double() - b.grad).abs().max().item()
                rels[f"d{n}"] = err / top if top else err
                assert rels[f"d{n}"] <= SSD_GRAD_REL, (
                    f"{name} d{n} at {B} x {nc * Q} (Q {Q}): {rels[f'd{n}']:.2e}"
                    f" of the largest |g| (limit {SSD_GRAD_REL})")
            del f32, d64, y
            fwd_ms = _time_ms(torch, lambda: fn(*args))
            bwd_ms = _time_ms(torch, lambda: bwd(*args, dout), iters=5)
            bound_ms, by = _bound(flops, nbytes)
            key = f"{name} B {B} L {nc * Q} Q {Q}"
            out[key] = dict(grad_rel=rels, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
                            bwd_bound_ms=bound_ms, bwd_bound_by=by)
            log(f"{key}: gradients vs float64 " + ", ".join(
                f"{k} {v:.2e}" for k, v in rels.items())
                + f" of the largest |g| (limit {SSD_GRAD_REL}); kernel forward "
                f"{fwd_ms:.4f} ms, backward {bwd_ms:.4f} ms (bound "
                f"{bound_ms:.4f} ms, {by})")
        del ins, dy, dS
    torch.cuda.empty_cache()


def _ancestors(evt):
    chain = []
    while evt is not None:
        chain.append(evt)
        evt = evt.cpu_parent
    return chain


def _lm_part(chain, kernel, vp, attn_nodes):
    """The part of an LM train step that ``kernel`` belongs to, from its
    CPU op's ancestors (``chain``): the ``adamw`` range, the SSD
    backward's ranges, the SSD kernels by name; the ``sdpa`` range (the
    plain attention, forward and recompute), or a backward node whose
    forward op ran in it (``attn_nodes``: (sequence number, thread) of
    the ops under ``sdpa``); ops on a vocab-wide tensor (the unembed and
    the CE, each way); the gradient of a layer's slice of a stacked
    weight (written into a full-size zero tensor, ``SelectBackward0``)
    and its accumulation into ``.grad``; GEMMs forward, recomputed and
    backward (by op or kernel name); the rest (elementwise)."""
    names = [e.name for e in chain]
    if "adamw" in names:
        return "AdamW"
    if any(n in ("ssd_chunk_intra_backward", "ssd_chunk_state_backward")
           for n in names):
        return "SSD backward"
    if "ssd_" in kernel.name:
        return "SSD kernels"
    if "sdpa" in names:
        return "attention"
    if any(vp in (s if isinstance(s, (list, tuple)) else ())
           for e in chain for s in (e.input_shapes or ())):
        return "unembed/CE"
    node = next((e for e in chain if e.name.startswith(LMT_EVAL)), None)
    if node is not None:
        if (node.sequence_nr, node.fwd_thread) in attn_nodes:
            return "attention"
        if node.name[len(LMT_EVAL):] in ("SelectBackward0",
                                         "torch::autograd::AccumulateGrad"):
            return "layer-slice grads"
    if any(n in LMT_GEMM_OPS for n in names) or any(
            w in kernel.name.lower() for w in ("gemm", "nvjet", "xmma",
                                               "cutlass")):
        return "GEMMs"
    return "elementwise"


def lmtrain_profile(torch, fn, vp):
    """One LM train step under torch.profiler: device ms by part
    (``_lm_part``), wall by CUDA events, and the idle share."""
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
    events = prof.events()
    attn_nodes = {(e.sequence_nr, e.thread) for e in events
                  if e.sequence_nr >= 0 and e.name.startswith("aten::")
                  and "sdpa" in [a.name for a in _ancestors(e)]}
    parts = dict.fromkeys(LMT_PARTS, 0.0)
    attributed = device = 0.0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU:
            for k in e.kernels:
                parts[_lm_part(_ancestors(e), k, vp, attn_nodes)] += \
                    k.duration / 1e3
                attributed += k.duration / 1e3
        elif e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            device += (e.time_range.end - e.time_range.start) / 1e3
    parts["unattributed"] = device - attributed
    return dict(wall_ms=wall, busy_ms=device,
                idle_share=max(0.0, 1 - device / wall), parts=parts)


def _lm_batches(torch, cfg, B, S, n, seed=0):
    """n synthetic LM batches (the launcher's ``train_batches``) on the
    card, with a VLM's frontend or an enc-dec's frames drawn N(0, 1) in
    the model's type."""
    from repro_torch.data.synthetic import UserBehaviorStore, WorkloadConfig
    from repro_torch.models.layers import DTYPES
    gen = UserBehaviorStore(WorkloadConfig(vocab=cfg.vocab)).train_batches(
        B, S, seed=seed)
    stub = {"vlm": "frontend", "encdec": "frames"}.get(cfg.family)
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(n):
        b = {k: torch.as_tensor(v, device="cuda") for k, v in next(gen).items()}
        if stub:
            b[stub] = torch.randn((B, cfg.n_frontend_tokens, cfg.d_model),
                                  generator=g, device="cuda").to(
                                      DTYPES[cfg.dtype])
        out.append(b)
    return out


def _train_steps(torch, model, adamw, batches, warm):
    """``make_train_step`` over ``batches`` (the first ``warm`` untimed),
    counters zeroed after the warm-up and read after the last; returns
    (metrics of every step, ms of each timed step, launches by kernel,
    peak bytes of the timed steps, the step function, its state).
    Every parameter must end with a gradient that is finite."""
    from repro_torch.core.graphs import COUNTERS, read_counters, write_counters
    from repro_torch.launch.steps import make_train_step
    from repro_torch.training import optimizer as opt
    step = make_train_step(model, adamw)
    state = opt.init_state(step.params)
    metrics = [step(state, b) for b in batches[:warm]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    write_counters(dict.fromkeys(COUNTERS, 0))
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in batches[warm:]]
    for (a, b), batch in zip(events, batches[warm:]):
        a.record()
        metrics.append(step(state, batch))
        b.record()
    torch.cuda.synchronize()
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated()
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), (
            f"{name}: gradient {'missing' if p.grad is None else 'non-finite'}")
    return (metrics, [a.elapsed_time(b) for a, b in events], counts, peak,
            step, state)


def _losses(tag, metrics):
    losses = [m["loss"].item() for m in metrics]
    assert all(math.isfinite(x) for x in losses), f"{tag}: losses {losses}"
    return losses


def lmtrain_zamba2(torch, results):
    """The main path: ``zamba2_1p2b`` at full width and depth (38 layers,
    d 2048, bf16), B 2 x 4096, the launcher's schedule on its synthetic
    batches (AdamW with the global clip off: LMT_ADAMW): 2 warm-up and
    10 timed steps, the counters zeroed between (each SSD kernel: a
    forward and a recompute launch a Mamba2 layer and step), the loss on
    the first batch before the first step and after the last, then one
    profiled step."""
    import gc

    from repro_torch.models import build_model, get_config
    from repro_torch.training import optimizer as opt

    cfg = get_config("zamba2_1p2b")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    n = LMT_WARM + LMT_STEPS
    adamw = opt.AdamWConfig(warmup_steps=20, total_steps=n, **LMT_ADAMW)
    batches = _lm_batches(torch, cfg, LMT_B, LMT_S, n + 1)
    # the loss on the first batch before the first step and after the
    # last: a new batch a step adds its own spread to the per-step losses
    # (~0.02 nats), more than 12 warm-up steps move them
    with torch.no_grad():
        probe = [model.loss(batches[0])[0].item()]
    seen, restore = _ssd_spy(torch)
    t1 = time.perf_counter()
    try:
        metrics, ms, counts, peak, step, state = _train_steps(
            torch, model, adamw, batches[:n], LMT_WARM)
    finally:
        restore()
    run_s = time.perf_counter() - t1
    _assert_bf16_launches(torch, seen, "zamba2 train")
    live_args = [_nbytes(step.params), _nbytes(state), _nbytes(batches[0])]
    losses = _losses("zamba2_1p2b", metrics)
    launches = {k: counts.pop(k) for k in ("ssd_chunk_intra", "ssd_chunk_state")}
    assert not any(counts.values()), f"zamba2 train launched {counts}"
    want = 2 * cfg.n_layers * LMT_STEPS
    assert launches == dict.fromkeys(launches, want), (
        f"SSD launches {launches} in {LMT_STEPS} steps, expected {want} each "
        f"(2 a Mamba2 layer and step: the forward and its recompute)")
    for k, v in launches.items():
        results[k]["launches"] += v
        results[k]["launches_bf16"] = results[k].get("launches_bf16", 0) + v
    assert peak < LMT_PEAK_GIB * 2**30, f"peak {peak / 2**30:.2f} GiB"
    with torch.no_grad():
        probe.append(model.loss(batches[0])[0].item())
    assert all(math.isfinite(x) for x in probe) and probe[1] < probe[0], (
        f"zamba2_1p2b: the loss on the first batch did not fall: {probe}")
    assert statistics.mean(losses[-3:]) < statistics.mean(losses[:3]), (
        f"zamba2_1p2b: the loss did not fall: {losses}")
    # what the launcher's clip at 1.0 would do to the last step's gradient
    sq = {n: p.grad.float().square().sum().item()
          for n, p in model.named_parameters()}
    gnorm = math.sqrt(sum(sq.values()))
    frozen = ((model.unembed.grad.float().abs() / max(gnorm, 1.0)) < adamw.eps
              ).float().mean().item()
    top = sorted(sq, key=sq.get, reverse=True)[:3]
    clip_note = dict(grad_norm=gnorm, top_share={k: sq[k] / gnorm ** 2
                                                 for k in top},
                     unembed_frozen_at_clip_1=frozen)
    med = statistics.median(ms)
    tok_s = LMT_STEPS * LMT_B * LMT_S * 1e3 / sum(ms)
    log(f"lmtrain zamba2_1p2b ({n_params / 1e9:.3f} B parameters, "
        f"{cfg.n_layers} layers, {cfg.dtype}; built and drawn in "
        f"{build_s:.1f} s): {LMT_B} x {LMT_S}, {LMT_WARM} warm-up + "
        f"{LMT_STEPS} timed steps in {run_s:.1f} s; ms/step {[round(x, 2) for x in ms]}"
        f", median {med:.2f}; {tok_s:.0f} tokens/s over the timed steps; "
        f"peak {peak / 2**30:.2f} GiB (limit {LMT_PEAK_GIB}); SSD launches "
        f"{launches} ({want // LMT_STEPS} a step each: {cfg.n_layers} forward "
        f"+ {cfg.n_layers} recompute); every gradient present and finite")
    log(f"lmtrain zamba2_1p2b losses {[round(x, 4) for x in losses]} "
        f"(first {losses[0]:.4f} -> last {losses[-1]:.4f}; on the first "
        f"batch {probe[0]:.4f} before the first step -> {probe[1]:.4f} after "
        f"the last); at a clip of 1.0 the last gradient (norm {gnorm:.4g}, "
        + ", ".join(f"{k} {v:.3f}" for k, v in clip_note["top_share"].items())
        + f" of its square) would leave {frozen:.3f} of the unembed's updates "
        f"below eps; grad norms "
        f"{[round(m['grad_norm'].item(), 3) for m in metrics]}")
    route = ssd_route_check(torch, model, cfg, LMT_B, LMT_S, grad=True)
    _assert_bf16_launches(torch, route, "zamba2 train layer 0")
    log(f"lmtrain zamba2_1p2b: all {len(seen)} SSD launches of the run took "
        f"bf16 x, B, C (no float32 copy); layer 0 at {LMT_B} x {LMT_S}, "
        f"forward and backward, equals the float32-copy route bit for bit "
        f"(output, states, the input's and every mixer weight's gradient)")
    prof = lmtrain_profile(torch, lambda: step(state, batches[n]),
                           cfg.vocab_padded)
    log(f"lmtrain zamba2_1p2b profiled step: wall {prof['wall_ms']:.2f} ms, "
        f"device busy {prof['busy_ms']:.2f} ms, idle share "
        f"{prof['idle_share']:.3f} (under the profiler); "
        + ", ".join(f"{k} {v:.2f}" for k, v in prof["parts"].items()))
    results.setdefault("_lmtrain", {})["zamba2_1p2b"] = dict(
        params=n_params, layers=cfg.n_layers, batch=LMT_B, seq=LMT_S,
        warm=LMT_WARM, steps=LMT_STEPS, ms_per_step=ms, median_ms=med,
        tokens_per_s=tok_s, peak_bytes=peak, live_args=live_args,
        losses=losses, first_batch_loss=probe, clip_note=clip_note,
        launches=launches,
        profile=prof,
        build_s=build_s, run_s=run_s)
    del model, step, state, batches, metrics
    gc.collect()
    torch.cuda.empty_cache()


def lmtrain_card_vs_cpu(torch, results):
    """The hybrid at zamba2's widths, 2 layers (one section), float32, B
    1 x 256 (two chunks): the loss and every gradient on the card
    against the CPU's, at the reference init (LMT_LOSS_REL,
    LMT_GRAD_REL_INIT of each leaf's largest |g|) and with the shared
    attention's wq / wk at fan-in d (LMT_LOSS_REL, LMT_GRAD_REL); then,
    on the latter weights, with a fault planted on the card: the intra
    wrapper routed to the bare launch (no Function, so no gradient
    through it), which must read above LMT_GRAD_REL.  Every variant is
    read before any is judged."""
    import dataclasses

    from repro_torch.data.synthetic import UserBehaviorStore, WorkloadConfig
    from repro_torch.kernels import ssd_chunk as sk
    from repro_torch.models import build_model, get_config

    cfg = dataclasses.replace(get_config("zamba2_1p2b"), n_layers=LMT_CPU_L,
                              attn_every=LMT_CPU_L, dtype="float32")
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    with torch.no_grad():              # the LoRA path live (lora_b is 0 at init)
        cpu.shared_attn.lora_b.normal_(
            std=0.02, generator=torch.Generator().manual_seed(6))
    batch = next(UserBehaviorStore(WorkloadConfig(vocab=cfg.vocab))
                 .train_batches(LMT_CPU_B, LMT_CPU_S, seed=1))

    def grads(model):
        model.requires_grad_(True)
        model.zero_grad(set_to_none=True)
        loss, _ = model.loss(batch)
        loss.backward()
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}

    t0 = time.perf_counter()
    readings = {}
    planted = "bare intra launch (planted)"
    for variant, limit in (("reference init", LMT_GRAD_REL_INIT),
                           ("wq/wk at fan-in d", LMT_GRAD_REL),
                           (planted, LMT_GRAD_REL)):
        if variant == "wq/wk at fan-in d":
            with torch.no_grad():
                for w in (cpu.shared_attn.attn.wq, cpu.shared_attn.attn.wk):
                    w.mul_(math.sqrt(w.shape[-2] / w.shape[-3]))
        if variant != planted:
            lc, gc_ = grads(cpu)
        gpu = build_model(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        routed = sk.ssd_chunk_intra
        if variant == planted:
            sk.ssd_chunk_intra = lambda *a, **k: sk._launch_intra(*a, **k)
        try:
            lg, gg = grads(gpu)
        finally:
            sk.ssd_chunk_intra = routed
        worst = (0.0, "")
        for name, want in gc_.items():
            got = gg[name]
            assert got is not None and bool(torch.isfinite(got).all()), name
            err = (got.cpu() - want).abs().max().item()
            top = want.abs().max().item()
            worst = max(worst, (err / top if top else err, name))
        readings[variant] = dict(loss=lg, cpu_loss=lc,
                                 loss_rel=abs(lg - lc) / abs(lc),
                                 grad_rel=worst[0], worst_leaf=worst[1],
                                 limit=limit)
        log(f"lmtrain card vs CPU ({variant}; hybrid at zamba2 widths, "
            f"{cfg.n_layers} layers, float32, {LMT_CPU_B} x {LMT_CPU_S}): "
            f"loss {lg:.6f} vs {lc:.6f} ({readings[variant]['loss_rel']:.2e} "
            f"relative), worst gradient {worst[0]:.2e} of its largest |g| "
            f"({worst[1]}) (limits {LMT_LOSS_REL}, {limit})")
        del gpu, gg
    for variant, r in readings.items():
        assert r["loss_rel"] <= LMT_LOSS_REL, (variant, r)
        if variant == planted:
            assert r["grad_rel"] > r["limit"], (
                f"the planted bare launch reads {r['grad_rel']:.2e}, within "
                f"the limit {r['limit']}")
        else:
            assert r["grad_rel"] <= r["limit"], (variant, r)
    results.setdefault("_lmtrain", {})["card_vs_cpu"] = dict(
        readings, seconds=time.perf_counter() - t0)
    del cpu, gc_
    torch.cuda.empty_cache()


def lmtrain_run(torch, results, arch, layers, B, S, steps):
    """One other family at full width cut to ``layers``: ``steps`` AdamW
    steps (LMT_ADAMW, warm-up cut to one step) on one synthetic batch, so
    the loss on it must fall from the first step to the last (a step on
    a new batch would add that batch's own spread); every loss finite,
    every gradient present and finite, launch counts (an ``ssm_mamba2``
    stack: 2 of each SSD kernel a layer and step; every other family
    none)."""
    import dataclasses
    import gc

    from repro_torch.models import build_model, get_config
    from repro_torch.training import optimizer as opt

    if arch == "ssm_mamba2":
        cfg = dataclasses.replace(get_config("zamba2_1p2b"),
                                  family="ssm_mamba2", n_layers=layers)
    else:
        full = get_config(arch)
        cut = dict(n_layers=layers)
        if full.family == "encdec":
            cut["n_enc_layers"] = layers
        cfg = dataclasses.replace(full, **cut)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    adamw = opt.AdamWConfig(warmup_steps=1, total_steps=steps, **LMT_ADAMW)
    batches = _lm_batches(torch, cfg, B, S, 1) * steps
    metrics, ms, counts, peak, _, _ = _train_steps(torch, model, adamw,
                                                   batches, 0)
    losses = _losses(arch, metrics)
    assert losses[-1] < losses[0], f"{arch}: the loss did not fall: {losses}"
    want = dict.fromkeys(counts, 0)
    if cfg.family == "ssm_mamba2":
        want.update(ssd_chunk_intra=2 * layers * steps,
                    ssd_chunk_state=2 * layers * steps)
    assert counts == want, f"{arch}: launches {counts}, expected {want}"
    for k in ("ssd_chunk_intra", "ssd_chunk_state"):
        results[k]["launches"] += counts[k]
    F = cfg.n_frontend_tokens if cfg.family in ("vlm", "encdec") else 0
    tok_s = steps * B * S * 1e3 / sum(ms)
    aux = [m["aux"].item() for m in metrics] if "aux" in metrics[0] else None
    full_layers = get_config("zamba2_1p2b" if arch == "ssm_mamba2"
                             else arch).n_layers
    log(f"lmtrain {arch}: {cfg.n_layers} of {full_layers} layers"
        f"{' (+ as many encoder layers)' if cfg.family == 'encdec' else ''}, "
        f"{n_params / 1e9:.3f} B parameters ({cfg.dtype}, drawn in "
        f"{build_s:.1f} s), B {B} x {S}"
        f"{f' + {F} frames' if cfg.family == 'encdec' else f' + {F} frontend' if F else ''}: "
        f"ms/step {[round(x, 1) for x in ms]}, {tok_s:.0f} tokens/s, peak "
        f"{peak / 2**30:.2f} GiB, losses {[round(x, 4) for x in losses]}"
        f"{f', aux {[round(a, 5) for a in aux]}' if aux else ''}; launches "
        f"{ {k: v for k, v in counts.items() if v} or 'none'}; every "
        f"gradient present and finite")
    results.setdefault("_lmtrain", {})[arch] = dict(
        layers=cfg.n_layers, full_layers=full_layers, params=n_params,
        batch=B, seq=S, frontend=F, steps=steps, ms_per_step=ms,
        tokens_per_s=tok_s, peak_bytes=peak, losses=losses, aux=aux,
        launches=counts, build_s=build_s)
    del model, batches, metrics
    gc.collect()
    torch.cuda.empty_cache()


def lmtrain_phase(torch, results):
    """LM training for every family: the SSD Functions' gradients against
    float64, zamba2_1p2b at full width and depth (the main path), card
    vs CPU with a planted fault, then each other family at full width,
    cut in depth only."""
    t0 = time.perf_counter()
    ssd_grad_checks(torch, results)
    lmtrain_zamba2(torch, results)
    lmtrain_card_vs_cpu(torch, results)
    for run in LMT_RUNS:
        lmtrain_run(torch, results, *run)
    wall = time.perf_counter() - t0
    results["_lmtrain"]["wall_s"] = wall
    log(f"lmtrain phase: {wall:.1f} s of wall")


# --- phase 11b: the port under a process mesh -------------------------------------

DIST_W = 4                      # ranks, one process each
DIST_HSTU = dict(B=4, S=2048, steps=3, incr=16, items=64)
DIST_LM = dict(B=2, S=2048, steps=16)
DIST_LM_CHECK_LAYERS = 2        # float32 depth held against one process
DIST_MOE_LAYERS = 2             # deepseek_moe_16b's depth (full width)
DIST_LOSS_REL = 1e-5            # loss and grad_norm against one process
DIST_REL = 1e-4                 # logits and scores, of the largest |value|
# zamba2_1p2b at full width, one section (attn_every Mamba2 blocks and the
# shared attention), bf16, on (1, 4): prefill, decode steps, train steps
DIST_ZAMBA = dict(B=2, S=2048, steps=16, train=2, f32_steps=4)
DIST_UNCHECKED = ("qwen3_4b",)  # bf16, no one-process reference
DIST_LM_LAYERS = 4              # that run's depth of qwen3_4b's 36 (full width)
# the zamba2 section under FSDP on (4, 1): B 4 (a row a data rank)
DIST_FSDP_ZAMBA = dict(B=4, S=2048, steps=8, train=2)
DIST_RWKV = dict(B=2, S=256, steps=8, layers=2)       # f32, (1, 4)
DIST_ENCDEC = dict(B=4, S=256, steps=8, layers=2)     # f32, 2 + 2, (2, 2)
DIST_BF16_REL = 2 ** -5         # bf16 logits against one process, of the max
DIST_BF16_LOSS = 2 ** -9        # bf16 loss and grad_norm, relative
KV_SEQ_RING = 65536             # one sequence's ring, kv_seq-sharded on (4, 1)
KV_SEQ_STEPS = 16
KV_SEQ_QUARTER = 0.5            # the ring's mean rises by this a rank's part
KV_SEQ_FAULT_STEPS = 2          # steps decoded under each planted merge fault
LSE_TOL = 1e-4                  # decode_attn's lse against twin and float64


def dist_transport(torch):
    """NCCL with one card a rank when there are DIST_W cards, else gloo
    with every rank on cuda:0 (gloo takes CUDA tensors for all_reduce,
    the one collective the port calls)."""
    return "nccl" if torch.cuda.device_count() >= DIST_W else "gloo"


def _dist_rank(rank, backend, store, out_dir, plan):
    """One rank: for each (mesh sizes, job, args) of ``plan`` a
    ``ProcessMesh`` of those sizes over the one process group and
    ``job(mesh, device, *args)`` under its rules; the results saved for
    the parent.  A failure fails the spawn."""
    import torch
    from repro_torch.launch.mesh import ProcessMesh, destroy
    from repro_torch.models.partitioning import logical_rules
    torch.set_num_threads(2)
    dev = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
    torch.cuda.set_device(dev)
    try:
        out = []
        for sizes, job, args in plan:
            mesh = ProcessMesh.init(sizes, backend=backend,
                                    init_method=f"file://{store}", rank=rank,
                                    world_size=DIST_W)
            with logical_rules(mesh):
                out.append(job(mesh, dev, *args))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        destroy()


def _dist_run(torch, plan, backend):
    """Spawn the DIST_W ranks on ``plan``, wait for every one (a failed
    rank raises here) and load their results, rank by rank."""
    import tempfile
    import torch.multiprocessing as mp
    d = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    mp.spawn(_dist_rank, args=(backend, os.path.join(d, "store"), d, plan),
             nprocs=DIST_W, join=True)
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(DIST_W)]


def _fan_in_d(torch, model, cfg):
    """Every attention's wq and wk (a Transformer's, the hybrid's shared
    one, an enc-dec's self- and cross-attention) rescaled to fan-in
    d_model (the init rule takes a (d, heads, hd) weight's fan-in from
    its head count); the global head counts, so that a shard is scaled
    as its whole."""
    import math
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("attn.wq"):
                p.mul_(math.sqrt(max(cfg.n_heads, cfg.head_pad)
                                 / cfg.d_model))
            elif name.endswith("attn.wk"):
                p.mul_(math.sqrt(cfg.n_kv_heads / cfg.d_model))
    return model


def _spy_heads(torch, slots=None):
    """Record the heads every rank / decode / SSD launch is given:
    (kernel, q heads[, kv heads]) sets, by patching the launchers the
    wrappers call (the launches themselves are unchanged); ``slots``, a
    set, also takes each decode launch's ring slots and each rank
    launch's dense prefix tokens."""
    from repro_torch.kernels import cuda_lib
    seen = set()
    rank_attn, decode_attn = cuda_lib.rank_attn, cuda_lib.decode_attn
    ssd = cuda_lib.ssd_chunk

    def rank_spy(q, *a, **kw):
        seen.add(("rank_attn", q.shape[1]))
        if slots is not None and kw.get("prefix") is not None:
            slots.add(kw["prefix"][0].shape[2])
        return rank_attn(q, *a, **kw)

    def decode_spy(q, k, v, **kw):
        seen.add(("decode_attn", q.shape[1], k.shape[2]))
        if slots is not None:
            slots.add(k.shape[1])
        return decode_attn(q, k, v, **kw)

    def ssd_spy(kind, Cc, Bc, xc, *a, **kw):
        seen.add((f"ssd_chunk_{kind}", xc.shape[3]))
        return ssd(kind, Cc, Bc, xc, *a, **kw)
    cuda_lib.rank_attn, cuda_lib.decode_attn = rank_spy, decode_spy
    cuda_lib.ssd_chunk = ssd_spy
    return seen


def _timed_all_reduce(torch):
    """Time every ``torch.distributed.all_reduce`` while ``acc["on"]``:
    the card drained first (what was queued counts as compute), then
    the call's wall to the end of its copies on the card, the wait for
    the slowest rank included; the calls and seconds summed in ``acc``."""
    import torch.distributed as dist
    real = dist.all_reduce
    acc = {"on": False, "calls": 0, "s": 0.0}

    def spy(*a, **kw):
        if not acc["on"]:
            return real(*a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        acc["calls"] += 1
        acc["s"] += time.perf_counter() - t0
        return out
    dist.all_reduce = spy
    return acc


def _counted(fn):
    """(fn(), the kernel launches it counted)."""
    from repro_torch.core.graphs import read_counters, write_counters
    write_counters({n: 0 for n in read_counters()})
    out = fn()
    return out, {n: c for n, c in read_counters().items() if c}


def _resident(tensors):
    """Bytes of ``tensors`` on their device: numel * element size."""
    return sum(t.numel() * t.element_size() for t in tensors)


def _dist_hstu(mesh, dev, cfg, seed, batches, prompt, incr, items,
               fsdp=False, zero2=False):
    """hstu-gr on a (data, model) mesh under the rules with ``fsdp``: the
    train steps (``zero2``: ZeRO-2's, and no serve part after them),
    then prefill and ``rank_with_cache``; per part the launches, the
    heads each launch was given, the collectives and the time (rank 0's
    clock); the bytes of the rank's parameters and moments, and under
    ZeRO-2 a digest of its parameters' bits after the steps."""
    from repro_torch.models.partitioning import logical_rules
    with logical_rules(mesh, fsdp=fsdp):
        return _hstu_run(mesh, dev, cfg, seed, batches, prompt, incr, items,
                         zero2)


def _hstu_run(mesh, dev, cfg, seed, batches, prompt, incr, items, zero2):
    import hashlib

    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.partitioning import shard_batch
    from repro_torch.training import optimizer as opt
    from repro_torch.tree import leaves
    seen = _spy_heads(torch)
    model = build_model(cfg, device=dev).init(
        torch.Generator().manual_seed(seed))
    step = make_train_step(model, opt.AdamWConfig(warmup_steps=1),
                           zero2=zero2)
    state = opt.init_state(step.params, step.specs, step.moment_specs)
    ax = {"tokens": ("batch", None), "labels": ("batch", None)}
    out = {"train": [], "tally": {}, "param_bytes": _resident(
        model.parameters()), "moment_bytes": _resident(
        leaves(state["mu"]) + leaves(state["nu"]))}
    for i, b in enumerate(batches):
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in shard_batch(b, ax).items()}
        mesh.reset_tally()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, c = _counted(lambda: step(state, b))
        torch.cuda.synchronize()
        out["train"].append(dict(
            ms=(time.perf_counter() - t0) * 1e3, launches=c,
            **{k: float(v) for k, v in m.items()}))
        out["tally"]["train"] = mesh.collectives()
    model.requires_grad_(False)
    if zero2:
        out["digest"] = hashlib.sha256(b"".join(
            p.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()
            for p in leaves(step.params))).hexdigest()
        out["heads"] = sorted(seen)
        return out
    rows = {k: torch.as_tensor(v, device=dev) for k, v in shard_batch(
        {"p": prompt, "i": incr, "t": items},
        {"p": ("batch", None), "i": ("batch", None),
         "t": ("batch", None)}).items()}
    mesh.reset_tally()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (logits, psi), c_pre = _counted(lambda: model.prefill({"tokens": rows["p"]}))
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    out["tally"]["prefill"] = mesh.collectives()
    mesh.reset_tally()
    t0 = time.perf_counter()
    scores, c_rank = _counted(lambda: model.rank_with_cache(
        psi, rows["i"], rows["t"]))
    torch.cuda.synchronize()
    out.update(prefill_ms=pre_ms, rank_ms=(time.perf_counter() - t0) * 1e3,
               launches_prefill=c_pre, launches_rank=c_rank,
               heads=sorted(seen), logits=logits.float().cpu().numpy(),
               scores=scores.float().cpu().numpy(),
               local_heads=model.layers["uvqk"].shape[3])
    out["tally"]["rank"] = mesh.collectives()
    return out


def _assemble(parts, axes, shape, sizes):
    """The full array from every rank's shard (rank order)."""
    import numpy as np
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.models.partitioning import Rules, shard_slices
    out = np.full(shape, np.nan)
    for r, part in enumerate(parts):
        m = ProcessMesh.meta(sizes, rank=r)
        out[shard_slices(shape, Rules(m).spec(axes, shape=shape), m)] = part
    assert not np.isnan(out).any(), axes
    return out


def _rel(got, want):
    import numpy as np
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def _world1_hstu(torch, hcfg, batches, prompt, incr, items):
    """One process's hstu-gr: the train steps' metrics, then the prefill
    logits and the scores; the bytes of its parameters and moments."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.tree import leaves
    whole = build_model(hcfg, device="cuda").init(
        torch.Generator().manual_seed(7))
    step = make_train_step(whole, opt.AdamWConfig(warmup_steps=1))
    state = opt.init_state(step.params)
    nbytes = (_resident(whole.parameters()),
              _resident(leaves(state["mu"]) + leaves(state["nu"])))
    train = [{k: float(v) for k, v in step(state, {
        k: torch.as_tensor(v, device="cuda") for k, v in b.items()}).items()}
        for b in batches]
    whole.requires_grad_(False)
    logits, psi = whole.prefill({"tokens": torch.as_tensor(
        prompt, device="cuda")})
    scores = whole.rank_with_cache(psi, torch.as_tensor(incr, device="cuda"),
                                   torch.as_tensor(items, device="cuda"))
    return (train, logits.float().cpu().numpy(),
            scores.float().cpu().numpy(), nbytes)


def _rows(torch, batch, dev):
    """This rank's rows of a numpy batch (every entry sharded on its
    first dimension), on ``dev``."""
    from repro_torch.models.partitioning import current_rules, shard_batch
    ax = {k: ("batch",) + (None,) * (v.ndim - 1) for k, v in batch.items()}
    if current_rules() is not None:
        batch = shard_batch(batch, ax)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _family_run(torch, model, prompt, tokens, batches, dev, mesh=None,
                acc=None):
    """A prefill of ``prompt``, one eager decode step per column of
    ``tokens`` (no graphs around collectives) and an AdamW step per
    batch of ``batches`` (this rank's rows under a mesh, the whole batch
    without one): the logits, the train metrics, and under a mesh each
    part's launches, collectives and times (rank 0's clock).  With
    ``acc`` (``_timed_all_reduce``'s) the last decode step is profiled:
    its time inside ``all_reduce`` against its own, kept out of
    ``step_ms``."""
    from repro_torch.launch.steps import make_serve_step, make_train_step
    from repro_torch.training import optimizer as opt
    from repro_torch.tree import leaves

    def timed(fn):
        if mesh is not None:
            mesh.reset_tally()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, c = _counted(fn)
        torch.cuda.synchronize()
        return out, c, (time.perf_counter() - t0) * 1e3, (
            mesh.collectives() if mesh is not None else None)

    mine = _rows(torch, prompt, dev)
    toks = _rows(torch, {"t": tokens}, dev)["t"]
    (logits, cache), c, ms, tally = timed(lambda: model.prefill(mine))
    rec = dict(prefill_ms=ms, launches_prefill=c, tally_prefill=tally,
               logits=[logits.float().cpu().numpy()], step_ms=[],
               launches_decode={}, finite=bool(torch.isfinite(logits).all()),
               param_bytes=_resident(model.parameters()))
    serve = make_serve_step(model, graphs=False)
    B, S = mine["tokens"].shape
    n = toks.shape[1]
    for i in range(n):
        pos = torch.full((B,), S + i, device=dev)
        last = acc is not None and i == n - 1
        if last:
            acc.update(on=True, calls=0, s=0.0)
        (lg, cache), c, ms, tally = timed(lambda: serve(
            cache, {"token": toks[:, i:i + 1], "pos": pos}))
        if last:
            acc["on"] = False
            rec["profile"] = dict(step_ms=ms, all_reduces=acc["calls"],
                                  all_reduce_ms=acc["s"] * 1e3)
        else:
            rec["step_ms"].append(ms)
        rec["tally_decode"] = tally
        for name, k in c.items():
            rec["launches_decode"][name] = \
                rec["launches_decode"].get(name, 0) + k
        rec["finite"] &= bool(torch.isfinite(lg).all())
        rec["logits"].append(lg.float().cpu().numpy())
    del cache
    rec["train"] = []
    if batches:
        step = make_train_step(model, opt.AdamWConfig(warmup_steps=1))
        state = opt.init_state(step.params)
        rec["moment_bytes"] = _resident(leaves(state["mu"])
                                        + leaves(state["nu"]))
        for b in batches:
            bb = _rows(torch, b, dev)
            m, c, ms, tally = timed(lambda: step(state, bb))
            rec["train"].append(dict(ms=ms, launches=c, **{
                k: float(v) for k, v in m.items()}))
            rec["tally_train"] = tally
        model.requires_grad_(False)
        del step, state
    return rec


def _dist_family(mesh, dev, runs):
    """Every LM family on a mesh: per run (tag, cfg, seed, prompt, decode
    tokens, train batches) the model drawn from the seed (every rank
    draws the full weights and keeps its shard; wq / wk at fan-in d),
    then ``_family_run`` with its last decode step profiled; with the
    heads every kernel launch was given, a MoE's local experts and the
    peak memory."""
    import gc
    import torch
    from repro_torch.models import build_model
    seen = _spy_heads(torch)
    acc = _timed_all_reduce(torch)
    out = {}
    for tag, cfg, seed, prompt, tokens, batches in runs:
        seen.clear()
        t0 = time.perf_counter()
        model = _fan_in_d(torch, build_model(cfg, device=dev).init(
            torch.Generator().manual_seed(seed)), cfg)
        draw_s = time.perf_counter() - t0
        rec = _family_run(torch, model, prompt, tokens, batches, dev, mesh,
                          acc)
        rec.update(draw_s=draw_s, heads=sorted(seen),
                   local_experts=(model.layers.moe.wi.shape[1]
                                  if cfg.family == "moe" else None),
                   peak_bytes=torch.cuda.max_memory_allocated(dev))
        out[tag] = rec
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _dist_fsdp_family(mesh, dev, runs):
    """``_dist_family`` under the rules with fsdp: every weight's
    "embed" dimension on "data", gathered a layer at a time."""
    from repro_torch.models.partitioning import logical_rules
    with logical_rules(mesh, fsdp=True):
        return _dist_family(mesh, dev, runs)


def _world1_family(torch, cfg, seed, prompt, tokens, batches, full=False):
    """One process's logits and train metrics of ``_family_run`` (the
    whole record with ``full``)."""
    from repro_torch.models import build_model
    model = _fan_in_d(torch, build_model(cfg, device="cuda").init(
        torch.Generator().manual_seed(seed)), cfg)
    rec = _family_run(torch, model, prompt, tokens, batches, "cuda")
    del model
    torch.cuda.empty_cache()
    return rec if full else (rec["logits"], rec["train"])


def _axes_leaves(axes):
    """The logical axes of a cache's leaves, in ``tensor_leaves`` order."""
    if isinstance(axes, dict):
        return [a for k in sorted(axes) for a in _axes_leaves(axes[k])]
    if all(isinstance(a, (str, type(None))) for a in axes):
        return [axes]
    return [a for t in axes for a in _axes_leaves(t)]


def _ring_leaves(model, cache):
    """(leaf, its kv_seq dimension) of every leaf of a one-sequence
    KV_SEQ_RING cache whose sequence kv_seq shards (the rings' K and V,
    HSTU's psi; not a hybrid's Mamba2 states or an enc-dec's cross
    K/V)."""
    from repro_torch.core.graphs import tensor_leaves
    axes = _axes_leaves(model.cache_axes(1, KV_SEQ_RING))
    return [(t, ax.index("kv_seq"))
            for t, ax in zip(tensor_leaves(cache), axes) if "kv_seq" in ax]


def _kv_seq_cache(torch, model, seed, dev):
    """A one-sequence cache over KV_SEQ_RING slots, the same on every
    rank: every leaf 0.5 + 0.5 N(0, 1) drawn on the card from ``seed``
    (a mean keeps the attention's output from being the float
    cancellation of 65536 zero-mean values), and each ring leaf raised
    by KV_SEQ_QUARTER for each DIST_W-th of the ring before its slot: the
    ranks' parts then differ in their keys' scores and their values'
    mean, so a merge that drops the lse weights, or keeps one rank's
    part, moves the logits far past the limit."""
    from repro_torch.core.graphs import tensor_leaves
    from repro_torch.models.arch import zeros_from_specs
    specs = model.cache_specs(1, KV_SEQ_RING)
    cache = zeros_from_specs(specs[0] if model.cfg.hstu else specs, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for t in tensor_leaves(cache):
        t.copy_(0.5 + 0.5 * torch.randn(t.shape, generator=gen, device=dev))
    part = KV_SEQ_RING // DIST_W
    for t, d in _ring_leaves(model, cache):
        shape = [1] * t.ndim
        shape[d] = KV_SEQ_RING
        step = torch.arange(KV_SEQ_RING, device=dev) // part
        t.add_((KV_SEQ_QUARTER * step).to(t.dtype).view(shape))
    return cache


def _kv_seq_steps(torch, model, cache, tokens, dev, mesh=None, count=None):
    """One eager decode step of one sequence over ``cache`` per column of
    ``tokens`` (n of them; the first ``count`` where given), step i at
    position KV_SEQ_RING + i KV_SEQ_RING / n + 5 (so the slots written
    fall on every rank of "data" in turn): the logits, the ring slots
    the steps changed on this rank's part (global slots) and their rows
    (float32, one array a ring leaf), and under a mesh the launches, a
    step's collectives and times."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.partitioning import axis_index
    serve = make_serve_step(model, graphs=False, seq_len=KV_SEQ_RING)
    rec = dict(logits=[], step_ms=[], launches={})
    before = [t.clone() for t, _ in _ring_leaves(model, cache)]
    n = tokens.shape[1]
    for i in range(count or n):
        pos = torch.tensor([KV_SEQ_RING + i * (KV_SEQ_RING // n) + 5],
                           device=dev)
        if mesh is not None:
            mesh.reset_tally()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (lg, cache), c = _counted(lambda: serve(
            cache, {"token": tokens[:, i:i + 1], "pos": pos}))
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        for name, k in c.items():
            rec["launches"][name] = rec["launches"].get(name, 0) + k
        rec["logits"].append(lg.float().cpu().numpy())
        if mesh is not None:
            rec["tally"] = mesh.collectives()
    after = _ring_leaves(model, cache)
    first = axis_index("data") * after[0][0].shape[after[0][1]] \
        if after else 0
    changed = set()
    for b, (t, d) in zip(before, after):
        diff = (t != b).movedim(d, 0).reshape(t.shape[d], -1).any(1)
        changed |= set(diff.nonzero().flatten().tolist())
    rec["written"] = {first + j: [t.select(d, j).float().cpu().numpy()
                                  for t, d in after]
                      for j in sorted(changed)}
    return rec


def _merge_faults():
    """Planted faults of the kv_seq merge (``layers.merge_ring``), by
    name: "local", each rank's own part as the answer; "unweighted", the
    parts' mean without their lse weights."""
    from repro_torch.models.partitioning import axis_size, psum
    return {
        "local": lambda out, lse, axis: out,
        "unweighted": lambda out, lse, axis: (
            psum(out.float(), axis) / axis_size(axis)).to(out.dtype)}


def _dist_kv_seq(mesh, dev, runs):
    """One sequence decoded over a KV_SEQ_RING-slot ring under the kv_seq
    rule ("kv_seq" on "data", as the reference's dry-run sets it for a
    batch of one): per run (tag, cfg, seed, cache seed, tokens) the
    model, this rank's shard of the global cache (``_kv_seq_cache``,
    drawn whole on every rank, then cut) and ``_kv_seq_steps``; with the
    heads and ring slots each ``decode_attn`` / ``rank_attn`` launch was
    given.  A softmax ring then decodes its first KV_SEQ_FAULT_STEPS
    again from a fresh shard under each of ``_merge_faults``."""
    import gc
    import torch
    from repro_torch.models import build_model, layers
    from repro_torch.models.partitioning import logical_rules, shard_tree
    from repro_torch.tree import tree_map
    slots = set()
    seen = _spy_heads(torch, slots)
    out = {}
    with logical_rules(mesh, {"kv_seq": "data"}):
        for tag, cfg, seed, cseed, tokens in runs:
            seen.clear()
            slots.clear()
            model = _fan_in_d(torch, build_model(cfg, device=dev).init(
                torch.Generator().manual_seed(seed)), cfg)
            toks = torch.as_tensor(tokens, device=dev)

            def shard():
                whole = _kv_seq_cache(torch, model, cseed, dev)
                return tree_map(lambda t: t.clone(), shard_tree(
                    whole, model.cache_axes(1, KV_SEQ_RING)))
            cache = shard()
            ring = _ring_leaves(model, cache)[0]
            rec = _kv_seq_steps(torch, model, cache, toks, dev, mesh)
            rec.update(heads=sorted(seen), slots=sorted(slots),
                       local_ring=ring[0].shape[ring[1]], faults={})
            del cache, ring
            merge = layers.merge_ring
            for name, fault in ({} if cfg.hstu
                                else _merge_faults()).items():
                layers.merge_ring = fault
                try:
                    rec["faults"][name] = _kv_seq_steps(
                        torch, model, shard(), toks, dev,
                        count=KV_SEQ_FAULT_STEPS)["logits"]
                finally:
                    layers.merge_ring = merge
            out[tag] = rec
            del model
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _world1_kv_seq(torch, cfg, seed, cseed, tokens):
    """One process's ``_kv_seq_steps`` over the whole ring: the logits
    and the slots written with their rows."""
    from repro_torch.models import build_model
    model = _fan_in_d(torch, build_model(cfg, device="cuda").init(
        torch.Generator().manual_seed(seed)), cfg)
    cache = _kv_seq_cache(torch, model, cseed, "cuda")
    rec = _kv_seq_steps(torch, model, cache,
                        torch.as_tensor(tokens, device="cuda"), "cuda")
    del model, cache
    torch.cuda.empty_cache()
    return rec["logits"], rec["written"]


def dist_phase(torch, results):
    """The port under a process mesh: DIST_W ranks spawned once from this
    process (which has built the kernels), NCCL with a card each or gloo
    on one shared card (``dist_transport``), each rank running a (2, 2)
    mesh and then a (1, 4) mesh over its one process group.  This
    process first computes the same workloads alone on the same weights
    and batches, so that nothing else runs on the card while the ranks
    time their steps:

    * ``hstu-gr`` at full width on (2, 2), float32: DIST_HSTU's train
      steps (loss and grad_norm within DIST_LOSS_REL of one process),
      then prefill and ``rank_with_cache`` (logits and scores within
      DIST_REL of the largest |value|), ``hstu_attn`` and
      ``prefix_rank_attn`` on 2 heads a rank;
    * ``qwen3_4b`` at full width, DIST_LM_LAYERS of its 36 layers, bf16,
      on (1, 4): a DIST_LM prefill and decode steps, ``decode_attn`` on 8
      q / 2 kv heads a rank; at DIST_LM_CHECK_LAYERS layers in float32
      the logits within DIST_REL of one process's;
    * ``deepseek_moe_16b`` at full width and DIST_MOE_LAYERS layers on
      (1, 4), expert-parallel (16 experts a rank), float32, its logits
      against one process's likewise (data 1: the same capacity);
    * ``zamba2_1p2b`` at full width, one section (attn_every Mamba2
      blocks and the shared attention), bf16, on (1, 4): a DIST_ZAMBA
      prefill, decode steps and AdamW steps, the SSD kernels on 16 of
      64 heads and ``decode_attn`` on 8 of 32 a rank, the logits within
      DIST_BF16_REL and the loss and grad_norm within DIST_BF16_LOSS of
      one process's (bf16 sums in other orders); the same section in
      float32 on the same weights and inputs (fewer decode steps) within
      DIST_REL / DIST_LOSS_REL, and one process's bf16 logits against its
      float32 ones, the scale of bf16's own rounding;
    * ``rwkv6_1p6b`` at full width, DIST_RWKV's 2 layers, float32, on
      (1, 4) (8 heads a rank): prefill and decode, the logits within
      DIST_REL;
    * ``seamless_m4t_large_v2`` at full width, 2 + 2 layers, float32,
      on (2, 2): prefill, decode (``decode_attn`` over the self ring and
      the frames, 8 heads a rank) and an AdamW step, within DIST_REL /
      DIST_LOSS_REL;
    * one sequence over a KV_SEQ_RING-slot ring on (4, 1) under the
      kv_seq rule (16384 slots a rank): ``qwen3_4b`` bf16 at full width,
      2 layers, the zamba2 section above and the seamless 2 + 2 cut
      (each rank's ``decode_attn`` merged by its lse), and ``hstu-gr``
      at full width (``prefix_rank_attn`` on each rank's part of psi,
      the global 1 / n, summed), KV_SEQ_STEPS steps each, the logits
      against one process's decode of the whole ring; the slots written
      changed on their owner's part alone, with one process's rows; the
      ring's mean rising by KV_SEQ_QUARTER a rank's part, so that two
      planted merge faults (``_merge_faults``) fail the same limit;
    * FSDP and ZeRO-2: ``hstu-gr`` as above under fsdp on (2, 2) (the
      train steps, the prefill and ``rank_with_cache``: every weight's
      "embed" dimension on "data", gathered a layer at a time) and under
      ZeRO-2 (the train steps; the moments on "data", the parameters the
      same bits on every data rank); the zamba2 section above under fsdp
      on (4, 1) at DIST_FSDP_ZAMBA (a row a rank; kernels 5-7 on every
      head); each held against one process within the limits above, and
      each rank's bytes of parameters and moments equal to the dry-run's
      sizing under the same rules, beside one process's;
    * each workload's live collectives a step (rank 0's, every rank's
      equal) against the meta dry-run's at the same shape, mesh and
      rules;
      every run of the families and the kv_seq decode with its wq / wk
      at fan-in d, as the float32 LM checks below;
    * each LM's last decode step profiled on every rank: the time in
      ``all_reduce`` against the step's (``_timed_all_reduce``), one
      call a tallied collective.

    The float32 LM checks rescale wq / wk to fan-in d on both sides: at
    the reference init deepseek's attention logits reach a std of ~128
    and float32 reorderings flip its top-6 routing (the ``lm`` phase's
    LM_REL_INIT); qwen3's qk-norm undoes the scale.  A time under gloo
    on one card is not a multi-GPU figure."""
    import numpy as np
    from repro_torch.launch.dryrun import trace_collectives
    from repro_torch.models import get_config
    from repro_torch.models.config import InputShape
    from repro_torch.models.partitioning import make_mesh

    t_phase = time.perf_counter()
    backend = dist_transport(torch)
    multi = backend == "nccl"
    log(f"dist: {DIST_W} ranks over {backend}"
        + ("" if multi else " on one shared card (cuda:0): its times are "
           "not multi-GPU figures"))
    rec = {"transport": backend, "ranks": DIST_W,
           "cards": torch.cuda.device_count(), "times_multi_gpu": multi}
    rng = np.random.default_rng(0)
    g = lambda cfg, B, S: rng.integers(0, cfg.vocab, (B, S))
    H = DIST_HSTU
    hcfg = get_config("hstu-gr")
    batches = []
    for _ in range(H["steps"]):
        t = g(hcfg, H["B"], H["S"] + 1)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    prompt, incr, items = (g(hcfg, H["B"], n) for n in
                           (H["S"], H["incr"], H["items"]))
    fam14, fam22, kv_runs, fsdp41 = _dist_family_runs(rng, g)
    # one process's references first, so that nothing else shares the
    # card while the ranks time their steps
    t0 = time.perf_counter()
    want_train, w_logits, w_scores, w_bytes = _world1_hstu(
        torch, hcfg, batches, prompt, incr, items)
    want_fam = {run[0]: _world1_family(torch, *run[1:])
                for run in fam14 + fam22 if run[0] not in DIST_UNCHECKED}
    want_kv = {run[0]: _world1_kv_seq(torch, *run[1:]) for run in kv_runs}
    want_fsdp = {run[0]: _world1_family(torch, *run[1:], full=True)
                 for run in fsdp41}
    torch.cuda.empty_cache()
    world1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hstu = (hcfg, 7, batches, prompt, incr, items)
    outs = _dist_run(torch, [
        ((2, 2), _dist_hstu, hstu),
        ((1, 4), _dist_family, (fam14,)),
        ((2, 2), _dist_family, (fam22,)),
        ((4, 1), _dist_kv_seq, (kv_runs,)),
        ((2, 2), _dist_hstu, hstu + (True, False)),
        ((2, 2), _dist_hstu, hstu + (False, True)),
        ((4, 1), _dist_fsdp_family, (fsdp41,))], backend)
    spawn_s = time.perf_counter() - t0
    rec.update(spawn_s=spawn_s, world1_s=world1_s)

    # hstu-gr, (2, 2), float32 ---------------------------------------------
    houts = [o[0] for o in outs]
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for o in houts:
        for got, w in zip(o["train"], want_train):
            for k in worst:
                worst[k] = max(worst[k], abs(got[k] / w[k] - 1))
    assert max(worst.values()) <= DIST_LOSS_REL, worst
    s_rel = _rel(_assemble([o["scores"] for o in houts],
                           ("batch", None, None), w_scores.shape, (2, 2)),
                 w_scores)
    l_rel = _rel(_assemble([o["logits"] for o in houts],
                           ("batch", None, "vocab"), w_logits.shape, (2, 2)),
                 w_logits)
    assert max(s_rel, l_rel) <= DIST_REL, (s_rel, l_rel)
    L = hcfg.n_layers
    for o in houts:
        assert o["local_heads"] == 2
        assert o["heads"] == [("rank_attn", 2)], o["heads"]
        assert o["launches_prefill"] == {"hstu_attn": L}, o["launches_prefill"]
        assert o["launches_rank"] == {"prefix_rank_attn": L}, o["launches_rank"]
        assert all(t["launches"] == {"hstu_attn": 2 * L} for t in o["train"])
        assert o["tally"] == houts[0]["tally"]
        results["hstu_attn"]["launches"] += L + 2 * L * len(o["train"])
        results["prefix_rank_attn"]["launches"] += L
    mesh22 = make_mesh((2, 2), ("data", "model"))
    meta = {"train": trace_collectives(
        hcfg, InputShape("t", H["S"], H["B"], "train"), mesh22),
        "prefill": trace_collectives(
        hcfg, InputShape("p", H["S"], H["B"], "prefill"), mesh22)}
    for k, v in meta.items():
        assert houts[0]["tally"][k] == v, (k, houts[0]["tally"][k], v)
    o0 = houts[0]
    rec["hstu_gr"] = dict(
        mesh="2x2", dtype=hcfg.dtype, batch=H["B"], seq=H["S"],
        loss_rel=worst["loss"], grad_norm_rel=worst["grad_norm"],
        scores_rel=s_rel, logits_rel=l_rel,
        losses=[t["loss"] for t in o0["train"]],
        train_ms=[t["ms"] for t in o0["train"]], prefill_ms=o0["prefill_ms"],
        rank_ms=o0["rank_ms"], heads_per_rank=2, tally=o0["tally"],
        tally_equals_meta=True)
    log(f"dist hstu-gr (2, 2) f32 B {H['B']} x {H['S']}: losses "
        f"{rec['hstu_gr']['losses']} (|rel| to one process "
        f"{worst['loss']:.2e}, grad_norm {worst['grad_norm']:.2e}); prefill "
        f"logits {l_rel:.2e}, scores {s_rel:.2e} of max; hstu_attn and "
        f"prefix_rank_attn on 2 heads a rank; train "
        f"{[round(t, 1) for t in rec['hstu_gr']['train_ms']]} ms, prefill "
        f"{o0['prefill_ms']:.1f} ms, rank {o0['rank_ms']:.1f} ms (rank 0, "
        f"{backend}); collectives a train step "
        f"{o0['tally']['train']['total_bytes']} B, = meta")

    _check_dist_families(torch, results, rec, outs, fam14, fam22, want_fam,
                         backend)
    _check_dist_kv_seq(torch, results, rec, outs, kv_runs, want_kv, backend)
    _check_dist_fsdp_hstu(results, rec, outs, hcfg, want_train, w_logits,
                          w_scores, w_bytes, backend)
    _check_dist_fsdp_zamba(results, rec, outs, fsdp41, want_fsdp, backend)
    rec["wall_s"] = time.perf_counter() - t_phase
    results["_dist"] = rec
    log(f"dist phase: {rec['wall_s']:.1f} s of wall (one process's "
        f"references {world1_s:.1f} s, then the ranks {spawn_s:.1f} s)")


def _dist_family_runs(rng, g):
    """The dist phase's LM runs and kv_seq decodes: (runs on (1, 4), runs
    on (2, 2), kv_seq runs on (4, 1), FSDP runs on (4, 1)), inputs from
    ``rng`` (``g(cfg, B, S)`` draws tokens)."""
    import dataclasses

    from repro_torch.models import get_config

    def lm_batches(cfg, B, S, n, frames=False):
        out = []
        for _ in range(n):
            t = g(cfg, B, S + 1)
            b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
            if frames:
                b["frames"] = rng.normal(size=(
                    B, cfg.n_frontend_tokens, cfg.d_model)).astype("float32")
            out.append(b)
        return out

    def lm(tag, cfg, seed, B, S, steps, batches=()):
        return (tag, cfg, seed, {"tokens": g(cfg, B, S)}, g(cfg, B, steps),
                list(batches))

    D, Z, R, E = DIST_LM, DIST_ZAMBA, DIST_RWKV, DIST_ENCDEC
    qcfg = get_config("qwen3_4b")
    q32 = dataclasses.replace(qcfg, n_layers=DIST_LM_CHECK_LAYERS,
                              dtype="float32")
    dcfg = dataclasses.replace(get_config("deepseek_moe_16b"),
                               n_layers=DIST_MOE_LAYERS, dtype="float32")
    z = get_config("zamba2_1p2b")
    zcfg = dataclasses.replace(z, n_layers=z.attn_every)
    rcfg = dataclasses.replace(get_config("rwkv6_1p6b"),
                               n_layers=R["layers"], dtype="float32")
    ecfg = dataclasses.replace(get_config("seamless_m4t_large_v2"),
                               n_layers=E["layers"], n_enc_layers=E["layers"],
                               dtype="float32")
    eprompt = lm_batches(ecfg, E["B"], E["S"], 1, frames=True)[0]
    del eprompt["labels"]
    zamba = lm("zamba2_1p2b", zcfg, 21, Z["B"], Z["S"], Z["steps"],
               lm_batches(zcfg, Z["B"], Z["S"], Z["train"]))
    # the same section, weights, prompt, first steps and batches in float32
    zamba32 = ("zamba2_1p2b_f32", dataclasses.replace(zcfg, dtype="float32"),
               21, zamba[3], zamba[4][:, :Z["f32_steps"]], zamba[5])
    qcut = dataclasses.replace(qcfg, n_layers=DIST_LM_LAYERS)
    fam14 = [lm("qwen3_4b", qcut, 11, D["B"], D["S"], D["steps"]),
             lm("qwen3_4b_f32_2l", q32, 12, D["B"], D["S"], 2),
             lm("deepseek_moe_16b", dcfg, 13, D["B"], D["S"], 2),
             zamba, zamba32,
             lm("rwkv6_1p6b", rcfg, 22, R["B"], R["S"], R["steps"])]
    fam22 = [("seamless_m4t_large_v2", ecfg, 23, eprompt,
              g(ecfg, E["B"], E["steps"]),
              lm_batches(ecfg, E["B"], E["S"], 1, frames=True))]
    q2 = dataclasses.replace(qcfg, n_layers=2)
    hcfg = get_config("hstu-gr")
    kv_runs = [("qwen3_4b", q2, 24, 124, g(q2, 1, KV_SEQ_STEPS)),
               ("zamba2_1p2b", zcfg, 21, 125, g(zcfg, 1, KV_SEQ_STEPS)),
               ("hstu_gr", hcfg, 26, 126, g(hcfg, 1, KV_SEQ_STEPS)),
               ("seamless_m4t_large_v2", ecfg, 23, 127,
                g(ecfg, 1, KV_SEQ_STEPS))]
    F = DIST_FSDP_ZAMBA
    fsdp41 = [lm("zamba2_1p2b_fsdp", zcfg, 21, F["B"], F["S"], F["steps"],
                 lm_batches(zcfg, F["B"], F["S"], F["train"]))]
    return fam14, fam22, kv_runs, fsdp41


def _family_launches(cfg, steps, train_steps):
    """The launches of a family run by part: (prefill, decode, each train
    step)."""
    if cfg.family == "hybrid":
        L, n_sec = cfg.n_layers, cfg.n_layers // cfg.attn_every
        ssd = {"ssd_chunk_intra": L, "ssd_chunk_state": L}
        return ssd, {"decode_attn": n_sec * steps}, \
            {k: 2 * v for k, v in ssd.items()}
    if cfg.family == "encdec":
        return {}, {"decode_attn": 2 * cfg.n_layers * steps}, {}
    if cfg.family.startswith("ssm"):
        return {}, {}, {}
    return {}, {"decode_attn": cfg.n_layers * steps}, {}


def _check_dist_families(torch, results, rec, outs, fam14, fam22, want_fam,
                         backend):
    """The LM runs against one process's (all but DIST_UNCHECKED):
    logits, loss and grad_norm; every launch on this rank's heads (a
    MoE's experts split alike); launches by part; every rank's
    collectives equal, and rank 0's equal to the meta dry-run's at the
    same shapes and mesh; the profiled decode step's time inside
    ``all_reduce``, one call a tallied collective.  A float32 twin of a
    bf16 run ("<tag>_f32", the same seed and inputs) also gives one
    process's bf16 gap to float32, the scale of bf16's own rounding."""
    from repro_torch.launch.dryrun import trace_collectives
    from repro_torch.models.config import InputShape
    from repro_torch.models.partitioning import make_mesh
    for sizes, idx, fam in (((1, 4), 1, fam14), ((2, 2), 2, fam22)):
        mesh = make_mesh(sizes, ("data", "model"))
        n = sizes[1]
        for tag, cfg, seed, prompt, toks, batches in fam:
            rs = [o[idx][tag] for o in outs]
            bf16 = cfg.dtype == "bfloat16"
            lim = DIST_BF16_REL if bf16 else DIST_REL
            loss_lim = DIST_BF16_LOSS if bf16 else DIST_LOSS_REL
            rels, worst = [], {"loss": 0.0, "grad_norm": 0.0}
            if tag not in DIST_UNCHECKED:
                w_logits, w_train = want_fam[tag]
                rels = [_rel(_assemble([r["logits"][i] for r in rs],
                                       ("batch", None, "vocab"), w.shape,
                                       sizes), w)
                        for i, w in enumerate(w_logits)]
                assert max(rels) <= lim, (tag, rels)
                for r in rs:
                    for got, w in zip(r["train"], w_train):
                        for k in worst:
                            worst[k] = max(worst[k], abs(got[k] / w[k] - 1))
                assert max(worst.values()) <= loss_lim, (tag, worst)
            own = None
            if bf16 and f"{tag}_f32" in want_fam:
                own = max(_rel(a, b) for a, b in zip(
                    want_fam[tag][0], want_fam[f"{tag}_f32"][0]))
            pre, dec, tr = _family_launches(cfg, toks.shape[1], len(batches))
            heads = set()
            if cfg.family == "hybrid":
                heads = {("ssd_chunk_intra", cfg.n_ssm_heads // n),
                         ("ssd_chunk_state", cfg.n_ssm_heads // n)}
            if not cfg.family.startswith("ssm"):
                heads.add(("decode_attn", cfg.n_heads // n,
                           cfg.n_kv_heads // n))
            r0 = rs[0]
            for r in rs:
                assert r["finite"], tag
                assert set(r["heads"]) == heads, (tag, r["heads"])
                assert r["launches_prefill"] == pre, (tag, r["launches_prefill"])
                assert r["launches_decode"] == dec, (tag, r["launches_decode"])
                assert all(t["launches"] == tr for t in r["train"]), tag
                assert r["local_experts"] == (cfg.n_experts // n if
                                              cfg.family == "moe" else None)
                for k in ("tally_prefill", "tally_decode", "tally_train"):
                    assert r.get(k) == r0.get(k), (tag, k)
                assert r["profile"]["all_reduces"] == sum(
                    v["count"] for v in r0["tally_decode"].values()
                    if isinstance(v, dict)), (tag, r["profile"],
                                              r0["tally_decode"])
                for part in [pre, dec] + [tr] * len(r["train"]):
                    for name, c in part.items():
                        results[name]["launches"] += c
            B, S = prompt["tokens"].shape
            shapes = [("prefill", "p"), ("decode", "d")] + (
                [("train", "t")] if batches else [])
            for kind, short in shapes:
                m = trace_collectives(cfg, InputShape(short, S, B, kind), mesh)
                assert r0[f"tally_{kind}"] == m, (tag, kind,
                                                  r0[f"tally_{kind}"], m)
            shares = [round(r["profile"]["all_reduce_ms"]
                            / r["profile"]["step_ms"], 3) for r in rs]
            row = dict(mesh="x".join(map(str, sizes)), dtype=cfg.dtype,
                       layers=cfg.n_layers, batch=B, prompt=S,
                       steps=toks.shape[1],
                       logits_rel=max(rels) if rels else None,
                       loss_rel=worst["loss"],
                       grad_norm_rel=worst["grad_norm"],
                       bf16_vs_f32_one_process=own,
                       heads=sorted(heads),
                       experts_per_rank=r0["local_experts"],
                       draw_s=r0["draw_s"], prefill_ms=r0["prefill_ms"],
                       step_ms=r0["step_ms"],
                       decode_profile={i: r["profile"]
                                       for i, r in enumerate(rs)},
                       train_ms=[t["ms"] for t in r0["train"]],
                       losses=[t["loss"] for t in r0["train"]],
                       peak_bytes=r0["peak_bytes"],
                       tally={k: r0.get(f"tally_{k}") for k, _ in shapes},
                       tally_equals_meta=True)
            rec[tag] = row
            log(f"dist {tag} ({sizes[0]}, {sizes[1]}) {cfg.dtype} "
                f"{cfg.n_layers} layers, B {B} x {S} + {toks.shape[1]} steps"
                f" + {len(batches)} train: "
                + (f"logits {max(rels):.2e} of max (per part "
                   f"{[float(f'{x:.2e}') for x in rels]}), loss "
                   f"{worst['loss']:.2e}, grad_norm {worst['grad_norm']:.2e} "
                   f"against one process" if rels else
                   "not held against one process")
                + (f"; one process's bf16 against its float32 {own:.2e} of "
                   f"max" if own is not None else "")
                + f"; launches on {sorted(heads)} a rank"
                + (f", {r0['local_experts']} experts a rank"
                   if r0["local_experts"] else "")
                + f"; drawn in {r0['draw_s']:.1f} s, prefill "
                f"{r0['prefill_ms']:.1f} ms, decode "
                + (f"{statistics.median(r0['step_ms']):.2f} ms a step "
                   f"(median), " if r0["step_ms"] else "")
                + f"train {[round(t, 1) for t in row['train_ms']]} ms (rank "
                f"0, {backend}: not multi-GPU times); the last decode step "
                f"profiled, every rank's all_reduce share of it {shares} "
                f"({r0['profile']['all_reduces']} calls, rank 0 "
                f"{r0['profile']['all_reduce_ms']:.1f} of "
                f"{r0['profile']['step_ms']:.1f} ms); collectives: prefill "
                f"{r0['tally_prefill']['total_bytes']} B, a decode step "
                f"{r0['tally_decode']['total_bytes']} B"
                + (f", a train step {r0['tally_train']['total_bytes']} B"
                   if batches else "") + ", = meta")


def _sizing(cfg, sizes, fsdp=False, zero2=False):
    """The dry-run's bytes of one rank's parameters and of its moments
    (``dryrun._sum_bytes`` under ``Rules(mesh, fsdp=fsdp)``, the moments
    by ``opt.state_axes(..., zero2)``) on a (data, model) mesh of
    ``sizes``."""
    from repro_torch.launch.dryrun import _sum_bytes
    from repro_torch.models import build_model
    from repro_torch.models.partitioning import Rules, make_mesh
    from repro_torch.training import optimizer as opt
    mesh = make_mesh(sizes, ("data", "model"))
    rules = Rules(mesh, fsdp=fsdp)
    model = build_model(cfg, device="meta")
    p_axes, p_sds = model.param_axes(), model.abstract_params()
    m_axes = opt.state_axes(p_axes, zero2)
    m_sds = opt.abstract_state(p_sds)
    return (_sum_bytes(p_axes, p_sds, rules, mesh),
            sum(_sum_bytes(m_axes[k], m_sds[k], rules, mesh)
                for k in ("mu", "nu")))


def _check_dist_fsdp_hstu(results, rec, outs, hcfg, want_train, w_logits,
                          w_scores, w_bytes, backend):
    """hstu-gr on (2, 2) under FSDP (the train steps, the prefill and
    ``rank_with_cache``) and under ZeRO-2 (the train steps) against one
    process's run on the same weights and batches: loss and grad_norm
    within DIST_LOSS_REL, logits and scores within DIST_REL; kernels 1
    and 2 on 2 heads a rank and their launches; every rank's collectives
    equal and rank 0's the meta dry-run's under the same rules; each
    rank's bytes of parameters and moments equal to the dry-run's
    sizing; under ZeRO-2 the parameters' bits equal on every rank of a
    model coordinate."""
    from repro_torch.launch.dryrun import trace_collectives
    from repro_torch.models.config import InputShape
    from repro_torch.models.partitioning import make_mesh
    H, L = DIST_HSTU, hcfg.n_layers
    mesh22 = make_mesh((2, 2), ("data", "model"))
    for idx, tag, fsdp, zero2 in ((4, "hstu_gr_fsdp", True, False),
                                  (5, "hstu_gr_zero2", False, True)):
        rs = [o[idx] for o in outs]
        worst = {"loss": 0.0, "grad_norm": 0.0}
        for r in rs:
            for got, w in zip(r["train"], want_train):
                for k in worst:
                    worst[k] = max(worst[k], abs(got[k] / w[k] - 1))
        assert max(worst.values()) <= DIST_LOSS_REL, (tag, worst)
        row = dict(mesh="2x2", dtype=hcfg.dtype, batch=H["B"], seq=H["S"],
                   loss_rel=worst["loss"], grad_norm_rel=worst["grad_norm"],
                   losses=[t["loss"] for t in rs[0]["train"]],
                   train_ms=[t["ms"] for t in rs[0]["train"]])
        kinds = {"train": "t"} if zero2 else {"train": "t", "prefill": "p"}
        for k, short in kinds.items():
            m = trace_collectives(hcfg, InputShape(short, H["S"], H["B"], k),
                                  mesh22, fsdp=fsdp, zero2=zero2)
            assert rs[0]["tally"][k] == m, (tag, k, rs[0]["tally"][k], m)
        want_p, want_m = _sizing(hcfg, (2, 2), fsdp, zero2)
        for r in rs:
            assert r["tally"] == rs[0]["tally"], tag
            assert all(t["launches"] == {"hstu_attn": 2 * L}
                       for t in r["train"]), (tag, r["train"])
            assert (r["param_bytes"], r["moment_bytes"]) == (want_p, want_m), (
                tag, r["param_bytes"], r["moment_bytes"], want_p, want_m)
            assert r["heads"] == [("rank_attn", 2)], (tag, r["heads"])
            results["hstu_attn"]["launches"] += 2 * L * len(r["train"])
        if zero2:
            for r, o in enumerate(rs):
                assert o["digest"] == rs[r % 2]["digest"], (tag, r)
            row["same_bits_on_data_ranks"] = True
        else:
            s_rel = _rel(_assemble([o["scores"] for o in rs],
                                   ("batch", None, None), w_scores.shape,
                                   (2, 2)), w_scores)
            l_rel = _rel(_assemble([o["logits"] for o in rs],
                                   ("batch", None, "vocab"), w_logits.shape,
                                   (2, 2)), w_logits)
            assert max(s_rel, l_rel) <= DIST_REL, (tag, s_rel, l_rel)
            for r in rs:
                assert r["launches_prefill"] == {"hstu_attn": L}, tag
                assert r["launches_rank"] == {"prefix_rank_attn": L}, tag
                results["hstu_attn"]["launches"] += L
                results["prefix_rank_attn"]["launches"] += L
            row.update(scores_rel=s_rel, logits_rel=l_rel,
                       prefill_ms=rs[0]["prefill_ms"],
                       rank_ms=rs[0]["rank_ms"])
        row.update(param_bytes=rs[0]["param_bytes"],
                   moment_bytes=rs[0]["moment_bytes"],
                   bytes_equal_dryrun=True, unsharded_param_bytes=w_bytes[0],
                   unsharded_moment_bytes=w_bytes[1], tally=rs[0]["tally"],
                   tally_equals_meta=True)
        rec[tag] = row
        log(f"dist {tag} (2, 2) f32 B {H['B']} x {H['S']}: losses "
            f"{row['losses']} (|rel| to one process {worst['loss']:.2e}, "
            f"grad_norm {worst['grad_norm']:.2e})"
            + ("" if zero2 else f"; prefill logits {l_rel:.2e}, scores "
               f"{s_rel:.2e} of max")
            + f"; bytes a rank: parameters {row['param_bytes']}, moments "
            f"{row['moment_bytes']} (= the dry-run's; unsharded "
            f"{w_bytes[0]}, {w_bytes[1]})"
            + ("; parameters the same bits on every data rank" if zero2
               else "")
            + f"; train {[round(t, 1) for t in row['train_ms']]} ms (rank 0, "
            f"{backend}); collectives a train step: "
            + ", ".join(f"{k} {v['count']} / {v['bytes']} B" for k, v in
                        rs[0]["tally"]["train"].items()
                        if isinstance(v, dict) and v["count"])
            + ", = meta")


def _check_dist_fsdp_zamba(results, rec, outs, fsdp41, want, backend):
    """The zamba2 section under FSDP on (4, 1) against one process's run
    of the same weights and inputs: the logits within DIST_BF16_REL, the
    loss and grad_norm within DIST_BF16_LOSS; kernels 5-7 on every head
    and their launches by part; every rank's collectives equal and rank
    0's the meta dry-run's under fsdp; each rank's bytes of parameters
    and moments equal to the dry-run's sizing, beside one process's."""
    from repro_torch.launch.dryrun import trace_collectives
    from repro_torch.models.config import InputShape
    from repro_torch.models.partitioning import make_mesh
    mesh = make_mesh((4, 1), ("data", "model"))
    for tag, cfg, seed, prompt, toks, batches in fsdp41:
        rs = [o[6][tag] for o in outs]
        w = want[tag]
        B, S = prompt["tokens"].shape
        rels = [_rel(_assemble([r["logits"][i] for r in rs],
                               ("batch", None, "vocab"), wi.shape, (4, 1)),
                     wi) for i, wi in enumerate(w["logits"])]
        worst = {k: max(abs(got[k] / t[k] - 1) for r in rs
                        for got, t in zip(r["train"], w["train"]))
                 for k in ("loss", "grad_norm")}
        assert max(rels) <= DIST_BF16_REL, (tag, rels)
        assert max(worst.values()) <= DIST_BF16_LOSS, (tag, worst)
        pre, dec, tr = _family_launches(cfg, toks.shape[1], len(batches))
        heads = {("ssd_chunk_intra", cfg.n_ssm_heads),
                 ("ssd_chunk_state", cfg.n_ssm_heads),
                 ("decode_attn", cfg.n_heads, cfg.n_kv_heads)}
        want_p, want_m = _sizing(cfg, (4, 1), fsdp=True)
        r0 = rs[0]
        for r in rs:
            assert r["finite"] and set(r["heads"]) == heads, (tag, r["heads"])
            assert r["launches_prefill"] == pre, (tag, r["launches_prefill"])
            assert r["launches_decode"] == dec, (tag, r["launches_decode"])
            assert all(t["launches"] == tr for t in r["train"]), tag
            assert (r["param_bytes"], r["moment_bytes"]) == (want_p, want_m), (
                tag, r["param_bytes"], r["moment_bytes"], want_p, want_m)
            for k in ("tally_prefill", "tally_decode", "tally_train"):
                assert r[k] == r0[k], (tag, k)
            for part in [pre, dec] + [tr] * len(r["train"]):
                for name, c in part.items():
                    results[name]["launches"] += c
        for kind, short in (("prefill", "p"), ("decode", "d"),
                            ("train", "t")):
            m = trace_collectives(cfg, InputShape(short, S, B, kind), mesh,
                                  fsdp=True)
            assert r0[f"tally_{kind}"] == m, (tag, kind, r0[f"tally_{kind}"],
                                              m)
        rec[tag] = dict(
            mesh="4x1", dtype=cfg.dtype, layers=cfg.n_layers, batch=B,
            prompt=S, steps=toks.shape[1], logits_rel=max(rels),
            loss_rel=worst["loss"], grad_norm_rel=worst["grad_norm"],
            heads=sorted(heads), param_bytes=r0["param_bytes"],
            moment_bytes=r0["moment_bytes"], bytes_equal_dryrun=True,
            unsharded_param_bytes=w["param_bytes"],
            unsharded_moment_bytes=w["moment_bytes"],
            prefill_ms=r0["prefill_ms"], step_ms=r0["step_ms"],
            train_ms=[t["ms"] for t in r0["train"]],
            losses=[t["loss"] for t in r0["train"]],
            peak_bytes=r0["peak_bytes"],
            tally={k: r0[f"tally_{k}"] for k in ("prefill", "decode",
                                                 "train")},
            tally_equals_meta=True)
        log(f"dist {tag} (4, 1) {cfg.dtype} {cfg.n_layers} layers, B {B} x "
            f"{S} + {toks.shape[1]} steps + {len(batches)} train: logits "
            f"{max(rels):.2e} of max, loss {worst['loss']:.2e}, grad_norm "
            f"{worst['grad_norm']:.2e} against one process; kernels on "
            f"{sorted(heads)}; bytes a rank: parameters {r0['param_bytes']}, "
            f"moments {r0['moment_bytes']} (= the dry-run's; unsharded "
            f"{w['param_bytes']}, {w['moment_bytes']}); prefill "
            f"{r0['prefill_ms']:.1f} ms, decode "
            f"{statistics.median(r0['step_ms']):.2f} ms a step (median), "
            f"train {[round(t, 1) for t in rec[tag]['train_ms']]} ms (rank 0,"
            f" {backend}); collectives: prefill "
            f"{r0['tally_prefill']['total_bytes']} B, a decode step "
            f"{r0['tally_decode']['total_bytes']} B, a train step "
            f"{r0['tally_train']['total_bytes']} B, = meta")


def _kv_seq_expect(cfg):
    """A kv_seq decode step's kernel launches, the heads and slots a
    launch is given on every rank of (DIST_W, 1): HSTU's psi through
    ``prefix_rank_attn`` (kernel 2, the global 1 / n); a softmax ring
    through ``decode_attn`` (an enc-dec's cross-attention over its
    frames besides)."""
    local = KV_SEQ_RING // DIST_W
    if cfg.hstu:
        return ({"prefix_rank_attn": cfg.n_layers},
                [("rank_attn", cfg.n_heads)], [local])
    heads = [("decode_attn", cfg.n_heads, cfg.n_kv_heads)]
    if cfg.family == "hybrid":
        return {"decode_attn": cfg.n_layers // cfg.attn_every}, heads, [local]
    if cfg.family == "encdec":
        return ({"decode_attn": 2 * cfg.n_layers}, heads,
                sorted({local, cfg.n_frontend_tokens}))
    return {"decode_attn": cfg.n_layers}, heads, [local]


def _check_dist_kv_seq(torch, results, rec, outs, kv_runs, want_kv, backend):
    """The kv_seq decodes against one process's decode of the whole ring:
    the logits on every rank (within DIST_BF16_REL in bf16, DIST_REL in
    float32); the slots the steps wrote, each changed on its owner's
    part alone (no other slot of any rank changed) with the rows one
    process wrote there; each planted merge fault past the same limit;
    the kernel on KV_SEQ_RING / DIST_W slots and every head a rank, its
    launches, and a step's collectives (every rank's equal, rank 0's the
    meta dry-run's)."""
    from repro_torch.launch.dryrun import trace_collectives
    from repro_torch.models.config import InputShape
    from repro_torch.models.partitioning import make_mesh
    mesh = make_mesh((DIST_W, 1), ("data", "model"))
    local = KV_SEQ_RING // DIST_W
    for tag, cfg, seed, cseed, toks in kv_runs:
        rs = [o[3][tag] for o in outs]
        w, w_rows = want_kv[tag]
        lim = DIST_BF16_REL if cfg.dtype == "bfloat16" else DIST_REL
        rels = [max(_rel(r["logits"][i], wi) for r in rs)
                for i, wi in enumerate(w)]
        assert max(rels) <= lim, (tag, rels)
        written = set() if cfg.hstu else {
            (i * (KV_SEQ_RING // KV_SEQ_STEPS) + 5) % KV_SEQ_RING
            for i in range(KV_SEQ_STEPS)}
        assert set(w_rows) == written, (tag, sorted(w_rows))
        rows_rel = 0.0
        for rank, r in enumerate(rs):
            mine = {j for j in written if j // local == rank}
            assert set(r["written"]) == mine, (tag, rank, sorted(r["written"]))
            for j in mine:
                for got, want in zip(r["written"][j], w_rows[j]):
                    rows_rel = max(rows_rel, _rel(got, want))
        assert rows_rel <= lim, (tag, rows_rel)
        faults = {name: max(_rel(r["faults"][name][i], w[i]) for r in rs
                            for i in range(KV_SEQ_FAULT_STEPS))
                  for name in rs[0]["faults"]}
        assert cfg.hstu or len(faults) == 2, (tag, faults)
        assert all(v > lim for v in faults.values()), (tag, faults)
        want_l, heads, slots = _kv_seq_expect(cfg)
        want_l = {k: v * KV_SEQ_STEPS for k, v in want_l.items()}
        r0 = rs[0]
        for r in rs:
            assert r["local_ring"] == local and r["slots"] == slots, \
                (tag, r["local_ring"], r["slots"])
            assert r["heads"] == heads, (tag, r["heads"])
            assert r["launches"] == want_l, (tag, r["launches"])
            assert r["tally"] == r0["tally"], tag
            for name, c in want_l.items():
                results[name]["launches"] += c
        m = trace_collectives(cfg, InputShape("d", KV_SEQ_RING, 1, "decode"),
                              mesh, {"kv_seq": "data"})
        assert r0["tally"] == m, (tag, r0["tally"], m)
        kernel = next(iter(want_l))
        rec[f"{tag}_kv_seq"] = dict(
            mesh=f"{DIST_W}x1", dtype=cfg.dtype, layers=cfg.n_layers,
            ring=KV_SEQ_RING, slots_per_rank=local, steps=KV_SEQ_STEPS,
            logits_rel=max(rels), written_rows_rel=rows_rel,
            slots_written=len(written), planted_faults_rel=faults,
            kernel=kernel, step_ms=r0["step_ms"], tally=r0["tally"],
            tally_equals_meta=True)
        log(f"dist {tag} kv_seq ({DIST_W}, 1) {cfg.dtype} {cfg.n_layers} "
            f"layers, B 1 over {KV_SEQ_RING} slots ({local} a rank) + "
            f"{KV_SEQ_STEPS} steps: logits {max(rels):.2e} of max against one "
            f"process's whole ring (limit {lim:.2e}); "
            + (f"{len(written)} slots written, each on its owner's part "
               f"alone, rows {rows_rel:.2e} of max; planted merge faults "
               + ", ".join(f"{k} {v:.2e}" for k, v in faults.items())
               + " (each past the limit)" if written else
               "psi unchanged on every rank")
            + f"; {kernel} on {local} slots, {heads[0][1:]} heads a rank"
            + (", merged by its lse" if not cfg.hstu else
               ", the global 1 / n, summed")
            + f"; decode {statistics.median(r0['step_ms']):.2f} ms a step "
            f"(median, rank 0, {backend}); collectives a step "
            f"{r0['tally']['all-reduce']['count']} all-reduces, "
            f"{r0['tally']['total_bytes']} B, = meta")


# --- phase 12: the dry-run, and the roofline of every timed step ------------------

DRY_JOBS = 8       # dry-run combinations traced at once, a process each
DRY_MESHES = ("1x1", "16x16")     # sizing lines printed (2x16x16 recorded)
# the steps the phases above time: (label, arch, kind, B, S, the record's
# path in results, its ms key, its live-argument key, its peak key)
DRY_TIMED = (
    ("hstu-gr train", "hstu_gr", "train", TRAIN_B, TRAIN_S,
     ("_train", "run"), "median_ms", "live_args", "peak_bytes"),
    ("zamba2_1p2b train", "zamba2_1p2b", "train", LMT_B, LMT_S,
     ("_lmtrain", "zamba2_1p2b"), "median_ms", "live_args", "peak_bytes"),
    ("zamba2_1p2b prefill", "zamba2_1p2b", "prefill", HYB_B, HYB_S,
     ("_hybrid",), "prefill_ms", "live_args_prefill", "prefill_peak_bytes"),
    ("qwen3_4b prefill", "qwen3_4b", "prefill", LM_B, LM_RUNS[0][2],
     ("_lm", "qwen3_4b"), "prefill_ms", "live_args_prefill",
     "peak_prefill_bytes"),
    ("qwen3_4b decode", "qwen3_4b", "decode", LM_B, LM_RUNS[0][2],
     ("_lm", "qwen3_4b"), "decode_later_ms", "live_args_decode",
     "peak_decode_bytes"),
    ("rwkv6_1p6b decode", "rwkv6_1p6b", "decode", LM_B, RWKV_S,
     ("_ssm", "rwkv6_1p6b"), "decode_later_ms", "live_args_decode",
     "peak_decode_bytes"),
    ("seamless_m4t_large_v2 decode", "seamless_m4t_large_v2", "decode", LM_B,
     ED_S, ("_encdec", "seamless_m4t_large_v2"), "decode_later_ms",
     "live_args_decode", "peak_decode_bytes"),
)


def _record_at(results, path):
    rec = results
    for k in path:
        rec = rec.get(k) if isinstance(rec, dict) else None
    return rec


def dryrun_phase(torch, results, card):
    """(a) ``repro_torch.launch.dryrun`` on meta for every arch x shape
    (full config, full shape) on the 1 x 1, 16 x 16 and 2 x 16 x 16
    meshes: a sizing line per 1 x 1 and 16 x 16 record (arguments per
    device, and whether one H100's 80 GB holds them), every record under
    ``chiprun_out/dryrun``; the skipped set must be the reference's
    ``_should_skip``'s and nothing may fail.  (b) For each step the
    phases above timed, at exactly the timed shape: FLOPs and argument
    bytes counted on meta, the phase's own time (not rerun), model FLOPs,
    MFU and the roofline share against the published peak of the
    config's type, beside the card's name and power limit.  (c) Where
    the phase kept the step's live tensors: the parameters and the
    optimizer state or cache predicted to the byte; the batch too where
    its tensors have the spec's types (the train batches, int32), else
    the live int64 tokens at exactly twice the spec's int32; and the
    phase's peak at least the live arguments."""
    from repro_torch.benchmarks.roofline import model_flops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import CHIP_HBM_BYTES, peak_flops
    from repro_torch.models import ARCH_IDS, INPUT_SHAPES, get_config
    from repro_torch.models.config import InputShape

    t0 = time.perf_counter()
    timed = [(arch, InputShape(f"timed_{kind}_{B}x{S}", S, B, kind))
             for _, arch, kind, B, S, *_ in DRY_TIMED]
    combos = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    out = dryrun.run_all(combos + timed, ["card", "single", "multi"],
                         jobs=DRY_JOBS)
    recs = [r for combo in out[:len(combos)] for r in combo]
    timed_recs = [combo[0] for combo in out[len(combos):]]
    wall_a = time.perf_counter() - t0
    out_dir = os.path.join(ROOT, "chiprun_out", "dryrun")
    os.makedirs(out_dir, exist_ok=True)
    for r in recs:
        with open(os.path.join(out_dir, f"baseline__{r['arch']}__"
                               f"{r['shape']}__{r['mesh']}.json"), "w") as f:
            json.dump(r, f, indent=1)
    failed = [(r["arch"], r["shape"], r["mesh"], r.get("error"))
              for r in recs if r["status"] == "FAILED"]
    assert not failed, f"dry-run failures: {failed}"
    skipped = {(r["arch"], r["shape"]) for r in recs
               if r["status"] == "skipped"}
    want_skip = {(a, s) for a in ARCH_IDS for s in INPUT_SHAPES
                 if dryrun._should_skip(get_config(a), INPUT_SHAPES[s])}
    assert skipped == want_skip, (skipped, want_skip)
    for r in recs:
        if r["status"] == "ok" and r["mesh"] in DRY_MESHES:
            a = r["memory"]["argument_size_in_bytes"]
            log(f"dryrun {r['arch']} {r['shape']} on {r['mesh']}: arguments "
                f"{a / 1e9:.3f} GB per device "
                f"({'fits' if a <= CHIP_HBM_BYTES else 'does not fit'} one "
                f"H100's 80 GB), {r['jaxpr_flops_global']:.4e} FLOPs, "
                f"traced in {r['trace_s']:.2f} s")
    n_ok = sum(r["status"] == "ok" for r in recs)
    log(f"dryrun (a): {len(recs)} records ({n_ok} ok, {len(skipped)} arch x "
        f"shape skipped as the reference skips them), and the {len(timed)} "
        f"timed steps' at their own shapes, in {wall_a:.1f} s of wall, "
        f"{DRY_JOBS} processes")

    steps = {}
    for (label, arch, kind, B, S, path, ms_key, live_key,
         peak_key), (_, shape), sized in zip(DRY_TIMED, timed, timed_recs):
        assert sized["status"] == "ok" and sized["mesh"] == "1x1", sized
        rec = _record_at(results, path)
        if not rec or ms_key not in rec:
            log(f"dryrun (b): {label} not timed in this run (its phase did "
                f"not run)")
            continue
        cfg = get_config(arch)
        mem = sized["memory"]
        flops = int(sized["jaxpr_flops_global"])
        ms = rec[ms_key]
        peak = peak_flops(cfg.dtype)
        mf = model_flops(cfg, shape)
        t_ops = flops / peak
        t_bytes = (mem["argument_size_in_bytes"]
                   + mem["output_size_in_bytes"]) / HBM_BW
        bound_s = max(t_ops, t_bytes)
        row = dict(arch=arch, kind=kind, batch=B, seq=S, ms=ms, flops=flops,
                   model_flops=mf, mfu=mf / (ms * 1e-3 * peak),
                   counted_share=flops / (ms * 1e-3 * peak),
                   bound_ms=bound_s * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   roofline_share=bound_s / (ms * 1e-3),
                   peak_flops=peak, argument_bytes=mem["argument_size_in_bytes"],
                   argument_parts=mem["argument_parts"],
                   output_bytes=mem["output_size_in_bytes"],
                   trace_s=sized["trace_s"])
        log(f"dryrun (b) {label} {B} x {S} ({cfg.dtype}, peak "
            f"{peak:.3e} FLOP/s; card {card}): {ms:.4f} ms measured by its "
            f"phase; counted {flops:.4e} FLOPs ({row['counted_share']:.4f} "
            f"of peak), model FLOPs {mf:.4e}, MFU {row['mfu']:.4f}; "
            f"roofline bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
            f"(arguments {row['argument_bytes'] / 1e9:.4f} GB + outputs "
            f"{row['output_bytes'] / 1e9:.4f} GB), share {row['roofline_share']:.4f}")
        live = rec.get(live_key)
        if live is not None:
            pred = mem["argument_parts"]
            assert live[:-1] == pred[:-1], (label, live, pred)
            if kind == "train":
                assert live[-1] == pred[-1], (label, live, pred)
            else:
                assert live[-1] == 2 * pred[-1], (label, live, pred)
            pk = rec[peak_key]
            assert pk >= sum(live), (label, pk, live)
            row.update(live_parts=live, peak_bytes=pk)
            log(f"dryrun (c) {label}: predicted arguments {pred} bytes "
                f"(sum {sum(pred)}), live {live} (sum {sum(live)}): the "
                f"parameters{' and the state' if kind == 'train' else ' and the cache' if kind == 'decode' else ''} "
                f"to the byte, the batch "
                + ("to the byte" if kind == "train" else
                   "int64 tokens, twice the spec's int32")
                + f"; peak {pk} >= {sum(live)}")
        steps[label] = row
    wall = time.perf_counter() - t0
    results["_dryrun"] = dict(records=len(recs), ok=n_ok,
                              skipped=sorted(skipped), wall_a_s=wall_a,
                              wall_s=wall, steps=steps)
    log(f"dryrun phase: {wall:.1f} s of wall")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="kernels,serve,relay,bf16,graphs,costmodel,"
                            "hybrid,train,lm,ssm,encdec,lmtrain,dist,dryrun")
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
    walls = {}

    def run(name, phase, *extra):
        if name in phases:
            t0 = time.perf_counter()
            phase(torch, results, *extra)
            walls[name] = time.perf_counter() - t0

    run("kernels", kernel_phase)
    run("serve", serve_phase, args.requests)
    run("relay", relay_phase)
    run("bf16", bf16_phase, args.requests)
    run("graphs", graphs_phase, args.requests)
    run("costmodel", costmodel_phase)
    run("hybrid", hybrid_phase)
    run("train", train_phase)
    run("lm", lm_phase)
    run("ssm", ssm_phase)
    run("encdec", encdec_phase)
    run("lmtrain", lmtrain_phase)
    run("dist", dist_phase)
    run("dryrun", dryrun_phase, smi.splitlines()[0])
    log("phase walls (s): " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in walls.items()))

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
        bf = next((sh for sh in r.get("bf16", []) if sh.get("main")), None)
        if bf is not None:
            kernels[-1]["bf16"] = {
                "launches": r.get("launches_bf16", 0),
                **{k: bf.get(k) for k in (
                    "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
                    "bound_tf32_ms", "library_ms", "twin_rel", "f64_rel",
                    "max_abs_err")},
                "shape": {k: bf[k] for k in (
                    "B", "S", "P", "spans", "n_incr", "n_items", "L", "Q",
                    "H", "N", "dtype") if k in bf}}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "card_ids": card,
                   "build_log": cuda_lib.BUILD_LOG,
                   "wall_s": time.perf_counter() - wall0,
                   "phase_walls_s": walls, "results": results}, f, indent=1)
    log(f"phases {sorted(phases)}: {time.perf_counter() - wall0:.1f} s of "
        f"wall, the build included")
    if "_dist" in results:
        print(json.dumps({"dist": results["_dist"]}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
