"""Calibrate ``GRCostModel.batch_factor`` from measured group launches
(port of the reference's ``benchmarks/calibrate.py``).

    python -m repro_torch.benchmarks.calibrate [--device cuda] [--no-smoke]
        [--no-graphs] [--h2d] [--quick] [--buckets 64,128,256]

times ``BatchedLiveExecutor.rank_group`` on ``--device`` per
(prefix-bucket, batch-depth), derives the *marginal* cost of each
non-dominant batch member as a fraction of the dominant member's solo
latency

    factor(bucket, n) = (group_ms / solo_ms - 1) / (n - 1)

and writes a table the cost model loads through
``repro_torch.core.costmodel.load_batch_calibration`` /
``GRCostModel.with_calibration``, in the reference's schema: ``default``,
``meta``, ``buckets[bucket][batch]`` and, under ``--h2d``, an ``h2d``
block (scatter-insert of k fresh pages into a ``DevicePagePool`` against
re-shipping the whole pool, what every launch pays without
``--device-pool``) that ``GRCostModel.scatter_ms`` prices from.

``meta`` records the device (name and power limit as ``nvidia-smi``
gives them) and whether the launches replayed CUDA graphs (the default
on ``cuda``; ``--no-graphs`` runs them eagerly).  ``--no-smoke`` times
the full-width ``hstu-gr``.  The table goes to ``build/`` at the
repository root unless ``--out`` says otherwise.  A CPU run
(``--device cpu --quick``) exercises the path, not the numbers.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks import BUILD
from repro_torch.benchmarks._card import describe, sync

OUT = BUILD / "batch_factors.json"


def measure(buckets: Sequence[int], batches: Sequence[int],
            repeats: int = 3, incr_len: int = 16, n_items: int = 64,
            device="cuda", smoke: bool = True, graphs=None
            ) -> Tuple[Dict, List[Tuple]]:
    """Measure rank_group wall times and derive the factor table.
    Returns (calibration table, CSV rows)."""
    from repro_torch.core import BatchingConfig, GRCostModel, UserMeta, \
        get_executor
    from repro_torch.data.synthetic import UserBehaviorStore, WorkloadConfig
    from repro_torch.models import build_model, get_config
    from repro_torch.serving.batching import PendingRank

    device = resolve_device(device)
    cfg = get_config("hstu_gr", smoke=smoke)
    model = build_model(cfg, device=device).init(
        torch.Generator().manual_seed(0))
    store = UserBehaviorStore(WorkloadConfig(
        vocab=cfg.vocab, n_items=n_items, incr_len=incr_len, max_len=2048))
    ex = get_executor("batched")(
        model, store, cost=GRCostModel(cfg),
        batching=BatchingConfig(max_batch=max(batches)), graphs=graphs)

    def group_for(bucket: int, n: int) -> List[PendingRank]:
        group = []
        for i in range(n):
            meta = UserMeta(user_id=1000 * bucket + i, prefix_len=bucket,
                            incr_len=incr_len, n_items=n_items)
            psi, _, _ = ex.pre_infer(meta)
            group.append(PendingRank(user_id=meta.user_id, psi=psi,
                                     prefix_len=bucket, meta=meta))
        return group

    def timed(group) -> float:
        ex.rank_group(group)                      # warm / capture
        return float(np.median([ex.rank_group(group)[1]
                                for _ in range(repeats)]))

    rows, table = [], {}
    for bucket in buckets:
        solo_ms = timed(group_for(bucket, 1))
        per_bucket = {}
        for n in batches:
            if n <= 1:
                continue
            group_ms = timed(group_for(bucket, n))
            factor = max(0.0, (group_ms / solo_ms - 1.0) / (n - 1))
            per_bucket[str(n)] = round(factor, 4)
            rows.append((f"calibrate/bucket{bucket}/batch{n}",
                         group_ms * 1e3,
                         f"solo={solo_ms:.4f}ms group={group_ms:.4f}ms "
                         f"factor={factor:.3f}"))
        table[str(bucket)] = per_bucket
    factors = [v for row in table.values() for v in row.values()]
    cal = {"default": round(float(np.mean(factors)), 4) if factors else 0.2,
           "meta": {"model": cfg.name, "repeats": repeats,
                    "incr_len": incr_len, "n_items": n_items,
                    "device": describe(device),
                    "graphs": ex.graphs is not None},
           "buckets": table}
    return cal, rows


def measure_h2d(pool_pages: Sequence[int], insert_pages: Sequence[int],
                repeats: int = 3, page_tokens: int = 64, device="cuda",
                smoke: bool = True) -> Tuple[Dict, List[Tuple]]:
    """Measure device-pool H2D: scatter-insert (only the fresh pages
    cross the link, one in-place ``index_copy_``) vs full-pool re-ship
    (what every ``rank_with_pages`` launch pays WITHOUT the
    device-resident pool) per (pool pages, inserted pages) geometry.

    Emits the ``"h2d"`` calibration block ``GRCostModel.scatter_ms``
    reads via ``with_calibration``: ``scatter_bw`` / ``reship_bw`` are
    the median measured link bandwidths (bytes/s), ``grid`` keeps the
    per-geometry wall times for inspection."""
    from repro_torch.core.paging import DevicePagePool, PageLayout
    from repro_torch.models import get_config

    device = resolve_device(device)
    cfg = get_config("hstu_gr", smoke=smoke)
    layout = PageLayout.from_model_config(cfg, page_tokens)
    page_bytes = layout.page_bytes
    dtype = np.float32 if cfg.dtype == "float32" else np.float16

    rows, grid = [], {}
    scatter_bws, reship_bws = [], []
    rng = np.random.default_rng(0)
    for npages in pool_pages:
        buf = rng.standard_normal(
            (npages + 1, page_tokens, cfg.n_heads,
             cfg.head_dim)).astype(dtype)
        buf[npages] = 0.0                       # null page
        per_pool = {}
        for k in insert_pages:
            if k > npages:
                continue
            pages = list(range(k))
            pool = DevicePagePool(npages, page_bytes, device=device)
            pool.scatter(pages, buf)            # warm + buffer init
            sync(device)

            def t_scatter():
                t0 = time.perf_counter()
                pool.scatter(pages, buf)
                sync(device)
                return (time.perf_counter() - t0) * 1e3

            def t_reship():
                t0 = time.perf_counter()
                torch.from_numpy(buf).to(device, copy=True)
                sync(device)
                return (time.perf_counter() - t0) * 1e3

            t_reship()                          # warm the transfer path
            s_ms = float(np.median([t_scatter() for _ in range(repeats)]))
            r_ms = float(np.median([t_reship() for _ in range(repeats)]))
            scatter_bws.append(k * page_bytes / (s_ms / 1e3))
            reship_bws.append(buf.nbytes / (r_ms / 1e3))
            per_pool[str(k)] = {"scatter_ms": round(s_ms, 4),
                                "reship_ms": round(r_ms, 4)}
            rows.append((f"h2d/pool{npages}/insert{k}", s_ms * 1e3,
                         f"scatter={s_ms:.3f}ms reship={r_ms:.3f}ms "
                         f"x{r_ms / max(s_ms, 1e-9):.0f}"))
        grid[str(npages)] = per_pool
    h2d = {"scatter_bw": float(np.median(scatter_bws)) if scatter_bws
           else 0.0,
           "reship_bw": float(np.median(reship_bws)) if reship_bws
           else 0.0,
           "page_tokens": page_tokens, "page_bytes": page_bytes,
           "grid": grid}
    return h2d, rows


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="measure rank_group wall times per (bucket, batch) "
                    "and emit a batch-factor table for GRCostModel")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda or cpu)")
    ap.add_argument("--no-smoke", dest="smoke", action="store_false",
                    help="time the full-width hstu-gr (default: the "
                         "2-layer smoke model)")
    ap.add_argument("--no-graphs", dest="graphs", action="store_false",
                    help="run the launches eagerly instead of as "
                         "CUDA-graph replays (the default on cuda)")
    ap.add_argument("--buckets", default="64,128,256",
                    help="comma-separated prefix buckets to measure")
    ap.add_argument("--batches", default="1,2,4,8")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--h2d", action="store_true",
                    help="also measure device-pool H2D: scatter-insert "
                         "vs full-pool re-ship per (pool pages, "
                         "inserted pages); adds the 'h2d' block "
                         "GRCostModel.scatter_ms prices from")
    ap.add_argument("--pool-pages", default="256,1024",
                    help="pool geometries for --h2d")
    ap.add_argument("--insert-pages", default="1,8,64",
                    help="scatter sizes for --h2d")
    ap.add_argument("--quick", action="store_true",
                    help="one bucket, depths (1,2), single repeat "
                         "(CPU smoke: exercises the path, not the numbers)")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    buckets = [int(b) for b in args.buckets.split(",")]
    batches = [int(b) for b in args.batches.split(",")]
    pool_pages = [int(b) for b in args.pool_pages.split(",")]
    insert_pages = [int(b) for b in args.insert_pages.split(",")]
    if args.quick:
        buckets, batches, args.repeats = buckets[:1], [1, 2], 1
        pool_pages, insert_pages = pool_pages[:1], insert_pages[:2]

    cal, rows = measure(buckets, batches, repeats=args.repeats,
                        device=args.device, smoke=args.smoke,
                        graphs=None if args.graphs else False)
    if args.h2d:
        h2d, h2d_rows = measure_h2d(pool_pages, insert_pages,
                                    repeats=args.repeats,
                                    device=args.device, smoke=args.smoke)
        cal["h2d"] = h2d
        rows += h2d_rows
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(cal, indent=1, sort_keys=True))
    print(f"# wrote {out} (default factor {cal['default']}, fixed model "
          f"default 0.2; {cal['meta']['device']['name']}, graphs "
          f"{cal['meta']['graphs']})")
    return cal


if __name__ == "__main__":
    main()
