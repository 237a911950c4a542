# Port of benchmarks/run.py: module paths renamed repro -> repro_torch,
# benchmarks -> repro_torch.benchmarks; the headline defaults to build/;
# --device for the live rows; the roofline rows read the port's dry-run
# (repro_torch.launch.dryrun) priced with an H100's figures;
# --hardware / --calibration price the paper's headline figures with a
# HardwareModel measured on the card (benchmarks/hardware.py).
"""Benchmark entry point: ``PYTHONPATH=src python -m repro_torch.benchmarks.run``.

Prints ``name,us_per_call,derived`` CSV — one block per paper
table/figure (``figures``, ``ablations``, simulated) and the live-compute
microbenchmarks (``microbench``, on ``--device``, default ``cuda``).

Full runs also write ``build/BENCH_relay.json`` at the repository root
(override with ``--relay-json``): the machine-readable per-mode perf
headline — P99, SLO-compliant throughput, hit rates — in the schema of
the committed ``BENCH_relay.json``, which this entry point never writes.
``--quick`` skips the write unless a path is given.

``--quick`` runs a reduced subset (used by CI / test_benchmarks).

``--hardware PATH`` prices the paper's headline results with the
``HardwareModel`` in a table that ``python -m
repro_torch.benchmarks.hardware`` measured on the card: Fig. 11a, Fig.
11d and the headline, which then goes to ``build/BENCH_relay_h100.json``
with the table's device record in its ``meta``.  ``--calibration PATH``
adds a measured batch-factor table (``benchmarks/calibrate.py``,
``GRCostModel.with_calibration``).  No other figure and no live row runs
then.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from repro_torch.benchmarks import BUILD

# every BENCH_relay.json must report these serving modes
RELAY_MODES = ("baseline", "relay", "relay_dram", "relay_batched",
               "relay_paged", "relay_devpool", "relay_segments",
               "relay_multihost", "relay_disagg", "relay_cold",
               "relay_tenants")

RELAY_JSON = BUILD / "BENCH_relay.json"
RELAY_JSON_H100 = BUILD / "BENCH_relay_h100.json"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default="",
                    help="substring filter on benchmark function names")
    ap.add_argument("--relay-json", default=None,
                    help="perf-headline output path ('' disables; default "
                         "build/BENCH_relay.json, or "
                         "build/BENCH_relay_h100.json under --hardware; "
                         "skipped under --quick)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the live microbenchmarks "
                         "(cuda or cpu)")
    ap.add_argument("--hardware", default=None,
                    help="HardwareModel table measured on the card "
                         "(python -m repro_torch.benchmarks.hardware): "
                         "run Fig. 11a, Fig. 11d and the headline under it")
    ap.add_argument("--calibration", default=None,
                    help="with --hardware: a measured batch-factor table "
                         "(python -m repro_torch.benchmarks.calibrate)")
    args = ap.parse_args(argv)
    if args.calibration and not args.hardware:
        ap.error("--calibration needs --hardware")
    if args.relay_json is None:
        default = RELAY_JSON_H100 if args.hardware else RELAY_JSON
        args.relay_json = "" if args.quick else str(default)

    from repro_torch.benchmarks import ablations, figures, microbench

    cost, device = None, None
    if args.hardware:
        from repro_torch.benchmarks import hardware
        from repro_torch.core.costmodel import GRCostModel
        cost = GRCostModel(figures.HSTU, hardware.load(args.hardware))
        if args.calibration:
            cost = cost.with_calibration(args.calibration)
        device = hardware.read(args.hardware)["meta"]["device"]
        fig_fns = [figures.fig11a_max_seq_len, figures.fig11d_slo_throughput]
        micro_fns = []
    else:
        fig_fns = list(figures.ALL_FIGURES) + list(ablations.ALL_ABLATIONS)
        micro_fns = list(microbench.ALL_MICRO)
        if args.quick:
            fig_fns = [figures.fig11d_slo_throughput,
                       figures.fig12_local_vs_remote,
                       figures.table1_kv_footprint]
            micro_fns = []
    if args.only:
        fig_fns = [f for f in fig_fns if args.only in f.__name__]
        micro_fns = [f for f in micro_fns if args.only in f.__name__]

    print("name,us_per_call,derived")
    calls = [(fn, {"cost": cost} if cost else {}) for fn in fig_fns] + \
        [(fn, {"device": args.device}) for fn in micro_fns]
    for fn, kw in calls:
        t0 = time.time()
        try:
            rows = fn(**kw)
        except Exception as e:  # report, keep going
            print(f"{fn.__name__},0,ERROR: {type(e).__name__}: {e}")
            continue
        for name, us, derived in rows:
            print(f"{name},{us:.1f},{derived}")
        print(f"# {fn.__name__} took {time.time() - t0:.1f}s",
              file=sys.stderr)

    if args.relay_json and not args.only:
        t0 = time.time()
        headline = figures.bench_relay_summary(quick=args.quick, cost=cost)
        missing = [f"{mode}.{field}"
                   for mode in RELAY_MODES
                   for field in ("slo_qps", "p99_ms")
                   if field not in headline.get(mode, {})]
        if missing:  # CI gates on the headline schema — fail loudly
            raise SystemExit(f"BENCH_relay headline incomplete: {missing}")
        if cost is not None:
            headline["meta"].update(
                device=device, hardware=args.hardware,
                calibration=args.calibration, quick=args.quick)
        out = Path(args.relay_json)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as f:
            json.dump(headline, f, indent=1, sort_keys=True)
        print(f"# wrote {out} in {time.time() - t0:.1f}s", file=sys.stderr)

    print_roofline()


def print_roofline():
    """The roofline summary rows, if the dry-run has produced artifacts
    (``repro_torch.launch.dryrun``; none without them)."""
    try:
        from repro_torch.benchmarks import roofline
        rows = roofline.load()
        for r in rows:
            print(f"roofline/{r['arch']}/{r['shape']},"
                  f"{r['roofline_bound_s'] * 1e6:.1f},"
                  f"dominant={r['dominant']} useful={r['useful_ratio']}")
    except Exception as e:
        print(f"roofline,0,unavailable: {e}")


if __name__ == "__main__":
    main()
