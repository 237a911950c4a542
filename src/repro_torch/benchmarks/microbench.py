"""Live-engine microbenchmarks of the port (port of the reference's
``benchmarks/microbench.py``).

    python -m repro_torch.benchmarks.microbench [--device cuda] [--no-smoke]

``live_engine_ops`` times the ``LiveExecutor`` entry points (prefill of a
256-token prefix, rank with its psi, the full-rank fallback), with the
reference's row names.  On ``cuda`` each row is timed with the launches
replayed from CUDA graphs (the default) and eagerly, in turns, and the
row's number is the graph time.  ``kernel_rows`` takes the place of the
reference's interpret-mode kernel check: each served kernel at the row's
shape, the kernel wrapper against its plain twin (on the CPU the wrapper
runs the twin).  Every time is a host clock around work that ends in a
device synchronize, in microseconds per call.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks._card import describe, sync

PREFIX, N_INCR, N_ITEMS = 256, 16, 64


def _time(fn: Callable, device, n: int = 5) -> float:
    """Microseconds per call of ``fn`` after one warm call, the device
    synchronized before the clock stops."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / n * 1e6


def _model(device, smoke: bool):
    from repro_torch.models import build_model, get_config
    cfg = get_config("hstu_gr", smoke=smoke)
    return build_model(cfg, device=device).init(
        torch.Generator().manual_seed(0))


def live_engine_ops(device="cuda", smoke: bool = True) -> List[Tuple]:
    """The reference's three live-engine rows, on the port's
    ``LiveExecutor``: graphs against eager on a CUDA device."""
    from repro_torch.core import LiveExecutor, UserMeta
    from repro_torch.data.synthetic import UserBehaviorStore, WorkloadConfig

    device = resolve_device(device)
    model = _model(device, smoke)
    store = UserBehaviorStore(WorkloadConfig(
        vocab=model.cfg.vocab, n_items=N_ITEMS, incr_len=N_INCR))
    modes = ("graphs", "eager") if device.type == "cuda" else ("eager",)
    ex = {m: LiveExecutor(model, store, graphs=m == "graphs") for m in modes}
    meta = UserMeta(user_id=7, prefix_len=PREFIX, incr_len=N_INCR,
                    n_items=N_ITEMS)
    psi, nbytes, _ = ex[modes[0]].pre_infer(meta)
    ops = (("micro/pre_infer_256tok", lambda e: e.pre_infer(meta),
            f"psi={nbytes / 1e6:.2f}MB"),
           ("micro/rank_cached", lambda e: e.rank_cached(meta, psi),
            f"scores (1,{N_ITEMS},{model.cfg.n_tasks})"),
           ("micro/rank_full_fallback", lambda e: e.rank_full(meta),
            "baseline path"))
    rows = []
    for name, op, derived in ops:
        us = {m: [] for m in modes}
        for m in modes + modes[::-1]:             # in turns: g e e g
            us[m].append(_time(lambda: op(ex[m]), device))
        us = {m: min(v) for m, v in us.items()}
        if len(modes) == 2:
            derived += (f"; graphs {us['graphs']:.1f} us, eager "
                        f"{us['eager']:.1f} us")
        rows.append((name, us[modes[0]], derived))
    return rows


def kernel_rows(device="cuda", smoke: bool = True) -> List[Tuple]:
    """Each kernel the rows above launch, at their shapes: the wrapper
    (the CUDA kernel on ``cuda``) against its plain twin."""
    from repro_torch.kernels import hstu_attn as hk
    from repro_torch.kernels import prefix_rank_attn as rk

    device = resolve_device(device)
    cfg = _model("cpu", smoke).cfg
    H, D = cfg.n_heads, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device=device)
    Sq = N_INCR + N_ITEMS
    q, k, v = (randn(1, H, PREFIX, D) for _ in range(3))
    qr, kn, vn = (randn(1, H, Sq, D) for _ in range(3))
    kp, vp = randn(1, H, PREFIX, D), randn(1, H, PREFIX, D)
    cases = (
        (f"micro/hstu_attn_{PREFIX}", lambda: hk.hstu_attn(q, k, v),
         lambda: hk.hstu_attn_plain(q, k, v)),
        (f"micro/prefix_rank_attn_{PREFIX}",
         lambda: rk.prefix_rank_attn_split(qr, kp, vp, kn, vn,
                                           n_incr=N_INCR),
         lambda: rk.prefix_rank_attn_plain(
             qr, torch.cat([kp, kn], 2), torch.cat([vp, vn], 2),
             n_prefix=PREFIX, n_incr=N_INCR)))
    rows = []
    for name, kernel, plain in cases:
        err = (kernel() - plain()).abs().max().item()
        k_us, p_us = _time(kernel, device, 20), _time(plain, device, 5)
        rows.append((name, k_us, f"plain {p_us:.1f} us, max |kernel - "
                                 f"plain| {err:.2e} ({device.type})"))
    return rows


ALL_MICRO = [live_engine_ops, kernel_rows]


def main(argv=None) -> List[Tuple]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda or cpu)")
    ap.add_argument("--no-smoke", dest="smoke", action="store_false",
                    help="the full-width hstu-gr (default: the smoke model)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = [r for fn in ALL_MICRO for r in fn(device, args.smoke)]
    print(json.dumps({"device": describe(device)}))
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return rows


if __name__ == "__main__":
    main()
