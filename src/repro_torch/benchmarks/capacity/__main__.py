# Port of benchmarks/capacity/__main__.py: module paths renamed repro ->
# repro_torch, and --out defaults to build/BENCH_capacity.json.
"""Capacity harness entry point.

    PYTHONPATH=src python -m repro_torch.benchmarks.capacity [--quick]
                                           [--out PATH] [--matrix FILE] ...

Runs the declarative capacity matrix ({mode × L × workload × offered
QPS}) through the cluster simulator, finds each cell's SLO knee, and
writes ``build/BENCH_capacity.json`` and ``build/BENCH_capacity_curves.csv``
at the repository root (``--out`` elsewhere; the committed artifacts of
the same names at the root are only ever read, by ``check_regression``).
``--quick`` runs the 3-cell CI smoke matrix (short sims, coarse knees —
its ``meta.quick`` flag is recorded so the regression gate refuses a
quick file as a committed reference).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from repro_torch.benchmarks import BUILD

from .matrix import MatrixSpec, isolation_cell, run_matrix
from .report import render, write


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.capacity",
        description="trace-realistic capacity matrix: knee-finding + "
                    "latency-throughput curves per serving mode")
    ap.add_argument("--quick", action="store_true",
                    help="3-cell CI smoke matrix (short sims, coarse "
                         "knee bisection)")
    ap.add_argument("--out", default=str(BUILD / "BENCH_capacity.json"),
                    help="output JSON path (CSV curves written next to "
                         "it; '' disables writing)")
    ap.add_argument("--matrix", default=None,
                    help="JSON file with a declarative MatrixSpec "
                         "(see benchmarks/capacity/README.md)")
    ap.add_argument("--modes", default=None,
                    help="comma-separated mode override")
    ap.add_argument("--lengths", default=None,
                    help="comma-separated sequence-length override")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--duration", type=float, default=None,
                    help="per-point sim duration (s)")
    ap.add_argument("--no-isolation", action="store_true",
                    help="skip the two-tenant burst-isolation cell "
                         "(relay_tenants acceptance; run by default)")
    args = ap.parse_args(argv)

    if args.matrix:
        with open(args.matrix) as f:
            spec = MatrixSpec.from_dict(json.load(f))
        if args.quick:
            spec = _replace(spec, duration_s=4.0, quick=True)
    else:
        spec = MatrixSpec.quick_spec() if args.quick else MatrixSpec()
    if args.modes:
        spec = _replace(spec, modes=tuple(args.modes.split(",")))
    if args.lengths:
        spec = _replace(spec, lengths=tuple(
            int(x) for x in args.lengths.split(",")))
    if args.seed is not None:
        spec = _replace(spec, seed=args.seed)
    if args.duration is not None:
        spec = _replace(spec, duration_s=args.duration)

    t0 = time.time()
    cells = run_matrix(spec, progress=lambda m: print(m, file=sys.stderr))
    print(render(cells), end="")
    iso = None
    if not args.no_isolation:
        print("isolation: tenant A solo vs tenant B MMPP burst ...",
              file=sys.stderr)
        iso = isolation_cell(dur=spec.duration_s, slo_ms=spec.slo_ms,
                             seed=spec.seed, coarse=spec.quick)
        print(f"isolation: A knee {iso['solo']['knee_qps']:.0f} -> "
              f"{iso['burst']['knee_qps']:.0f} qps under burst, "
              f"hit_rate delta {iso['hit_delta']:+.4f}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        json_path, csv_path = write(args.out, cells, spec, iso)
        print(f"# wrote {json_path} + {csv_path} "
              f"in {time.time() - t0:.1f}s", file=sys.stderr)
    return 0


def _replace(spec: MatrixSpec, **kw) -> MatrixSpec:
    import dataclasses
    return dataclasses.replace(spec, **kw)


if __name__ == "__main__":
    raise SystemExit(main())
