#!/usr/bin/env python3
"""Chip smoke for the PyTorch / Hopper port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card, every phase

Phases, each fatal on failure (nothing is caught):

  1. require ``torch.cuda.is_available()``; print the card's name and
     power limit as ``nvidia-smi`` reports them;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``,
     cached in ``build/kernels/`` by a hash of the sources);
  3. hold each kernel against its plain-PyTorch version on the card at
     the live shapes (B in {1, 8}, H=4, D=64, 2048-token psi, 16 incr +
     64 items), at the paper's ranking shape (64 incr + 512 items over
     2048 tokens) and, for the paged kernel, with 64-token pages and
     ragged per-row lengths; assert the two bitwise properties (a row's
     result does not depend on its batch; paged == dense at equal padded
     length); time kernel and plain version with CUDA events;
  4. serve 24 requests at full ``hstu-gr`` width through
     ``repro_torch.launch.serve.main`` — live, ``--batched`` and
     ``--batched --device-pool`` — with every launch counter zeroed just
     before and read just after; each kernel must have launched, hits
     must include ``hbm_hit`` and the device pool must never re-ship;
  5. the relay-vs-full eps contract at full width, and full-width scores
     on the card against the same weights on the CPU;
  6. print the ``kernels`` JSON line, then the final device line.

``--phases`` runs a subset (e.g. ``--phases kernels``) while developing;
the full run takes no arguments.  Per-shape timings are also written to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

TOL = 3e-4          # f32 kernel vs plain: the repo's kernel tolerance
FP32_PEAK = 67e12   # H100 SXM FP32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12    # H100 SXM device memory, B/s
H, D = 4, 64
PSI, N_INCR, N_ITEMS = 2048, 16, 64
PAGE = 64
RAGGED = [2048, 1500, 933, 103, 2048, 640, 1, 1777]   # per-row psi tokens

SOURCE = "src/repro_torch/csrc/hstu_rank_attn.cu"
REPLACES = {
    "hstu_attn": "src/repro/kernels/hstu_attn.py:63",
    "prefix_rank_attn": "src/repro/kernels/prefix_rank_attn.py:67",
    "paged_prefix_rank_attn": "src/repro/kernels/paged_prefix_attn.py:122",
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


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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
        ms = _time_ms(torch, lambda: hk.hstu_attn(q, k, v))
        plain_ms = _time_ms(torch, lambda: hk.hstu_attn_plain(q, k, v), 5)
        pairs = B * H * S * (S + 1) // 2
        flops, nbytes = 4 * D * pairs, 4 * 4 * B * H * S * D
        bound_ms, by = _bound(flops, nbytes)
        results["hstu_attn"]["shapes"].append(dict(
            B=B, S=S, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=by, max_abs_err=e))
        log(f"hstu_attn B={B} S={S}: err {e:.2e} kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({by})")

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
            ms = _time_ms(torch, fn)
            plain_ms = _time_ms(torch, plain, 5)
            pairs = new_pairs + H * Sq * pre_keys
            flops = 4 * D * pairs
            nbytes = 4 * (4 * B * H * Sq * D + 2 * pre_keys * H * D)
            if name == "paged_prefix_rank_attn":
                nbytes += 4 * (2 * B * n_pages + B)     # tables + lengths
            bound_ms, by = _bound(flops, nbytes)
            results[name]["shapes"].append(dict(
                B=B, P=PSI, n_incr=n_incr, n_items=n_items, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                max_abs_err=e, prefix_tokens=pre_keys))
            log(f"{name} B={B} P={PSI} Sq={Sq}: err {e:.2e} kernel "
                f"{ms:.4f} ms plain {plain_ms:.4f} ms bound "
                f"{bound_ms:.4f} ms ({by})")
    log("kernels agree with their plain versions; bitwise properties hold")


# --- phase 4: the main path ------------------------------------------------------


def serve_phase(torch, results, requests):
    from repro_torch.kernels import hstu_attn as hk
    from repro_torch.kernels import paged_prefix_attn as pk
    from repro_torch.kernels import prefix_rank_attn as rk
    from repro_torch.launch import serve

    mods = {"hstu_attn": hk, "prefix_rank_attn": rk,
            "paged_prefix_rank_attn": pk}
    modes = (("live", [], ("hstu_attn", "prefix_rank_attn")),
             ("batched", ["--batched"], ("hstu_attn", "prefix_rank_attn")),
             ("batched-device-pool", ["--batched", "--device-pool"],
              ("hstu_attn", "paged_prefix_rank_attn")))
    for mode, flags, must in modes:
        for m in mods.values():
            m.launches = 0
        t0 = time.perf_counter()
        hits = serve.main(["--no-smoke", "--device", "cuda", "--requests",
                           str(requests), *flags])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: m.launches for n, m in mods.items()}
        log(f"serve {mode}: {wall:.1f} s hits={hits} launches={counts}")
        assert hits.get("hbm_hit", 0) > 0, f"{mode}: no hbm_hit in {hits}"
        for n in must:
            assert counts[n] > 0, f"{mode}: {n} never launched"
        for n, c in counts.items():
            results[n]["launches"] += c
        results["_serve"][mode] = dict(hits=hits, launches=counts,
                                       wall_s=wall, requests=requests)
    for n in mods:
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
    _, psi = gpu.prefill(on(prefix, gpu))
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
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        model.rank_with_cache(psi, incr, items)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        model.rank_with_cache(psi, incr, items)
    end.record()
    torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            model.rank_with_cache(psi, incr, items)
        torch.cuda.synchronize()
    by_kernel, by_host = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:   # kernels only
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            by_kernel[e.key] = t / 1e3 / iters
        elif e.self_cpu_time_total > 0:
            by_host[e.key] = e.self_cpu_time_total / 1e3 / iters
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    host = sorted(by_host.items(), key=lambda kv: -kv[1])[:6]
    log(f"breakdown rank_with_cache: wall {wall_ms:.4f} ms, device busy "
        f"{busy:.4f} ms, idle share "
        f"{max(0.0, 1 - busy / wall_ms) if busy else float('nan'):.3f}")
    for name, ms in top:
        log(f"  device {ms:.4f} ms  {name[:90]}")
    for name, ms in host:
        log(f"  host   {ms:.4f} ms  {name[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy, top=top, host=host)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="kernels,serve,relay")
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

    t0 = time.perf_counter()
    cuda_lib.library()
    log(f"built/loaded {SOURCE} in {time.perf_counter() - t0:.1f} s")
    for line in cuda_lib.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
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

    kernels = []
    for name, path in REPLACES.items():
        r = results[name]
        main_shape = r["shapes"][1] if len(r["shapes"]) > 1 else \
            (r["shapes"][0] if r["shapes"] else {})
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": path, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"],
            "ms": main_shape.get("ms"), "plain_ms": main_shape.get("plain_ms"),
            "bound_ms": main_shape.get("bound_ms"),
            "bound_by": main_shape.get("bound_by"), "library_ms": None,
            "shape": {k: main_shape[k] for k in ("B", "S", "P", "n_incr",
                                                 "n_items") if k in main_shape},
        })
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "results": results}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
