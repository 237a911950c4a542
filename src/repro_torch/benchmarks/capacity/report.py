# Copied from benchmarks/capacity/report.py (numpy-only): only module paths are renamed repro -> repro_torch, benchmarks -> repro_torch.benchmarks.
"""Committed capacity artifacts: ``BENCH_capacity.json`` + CSV curves.

``headline`` assembles the machine-readable matrix result — per-cell
knee QPS and latency–throughput curves under a ``meta`` block that
records full *workload provenance* (seed, population, skew/arrival
axes, sim duration), so ``benchmarks/check_regression.py`` can refuse
to diff capacity headlines produced under mismatched workloads.

``curves_csv`` flattens every cell's curve into one plottable CSV
(committed next to the JSON), and ``render`` prints the human-readable
knee table.
"""

from __future__ import annotations

import io
import json
from typing import Dict, Tuple

from .matrix import CURVE_FIELDS, MatrixSpec

#: meta fields two capacity headlines must share before a knee diff is
#: meaningful (sim duration and quick-ness are intentionally NOT here:
#: the CI smoke diffs its short coarse run against the committed full
#: run, under widened tolerances)
PROVENANCE_FIELDS = ("seed", "population", "slo_ms")


def headline(cells: Dict[str, Dict], spec: MatrixSpec,
             isolation: Dict = None) -> Dict:
    populations = sorted({w.population for w in spec.workloads})
    meta = {
        "seed": spec.seed,
        "population": populations[0] if len(populations) == 1
        else populations,
        "slo_ms": spec.slo_ms,
        "sim_s": spec.duration_s,
        "quick": spec.quick,
        "arrivals": sorted({w.arrival for w in spec.workloads}),
        "skews": sorted({w.skew for w in spec.workloads}),
        "matrix": spec.to_dict(),
    }
    out = {"meta": meta, "cells": cells}
    if isolation is not None:
        out["isolation"] = isolation
    return out


def curves_csv(cells: Dict[str, Dict]) -> str:
    """Flatten every cell curve into one CSV (one row per measured
    operating point) for plotting latency–throughput curves."""
    out = io.StringIO()
    cols = ("cell", "mode", "L", "workload", "knee_qps") + CURVE_FIELDS
    print(",".join(cols), file=out)
    for name, cell in cells.items():
        lead = [name, cell["mode"], str(cell["L"]), cell["workload_name"],
                str(cell["knee_qps"])]
        for row in cell["curve"]:
            vals = lead + [str(row.get(f, "")) for f in CURVE_FIELDS]
            print(",".join(vals), file=out)
    return out.getvalue()


def render(cells: Dict[str, Dict]) -> str:
    """Human-readable knee table (printed after a run)."""
    out = io.StringIO()
    width = max((len(n) for n in cells), default=4) + 2
    print(f"{'cell'.ljust(width)} {'knee_qps':>9} {'goodput':>8} "
          f"{'p99@knee':>9} {'hbm_hit':>8} {'miss':>6}", file=out)
    for name, cell in cells.items():
        at_knee = next((r for r in reversed(cell["curve"])
                        if r["offered_qps"] <= cell["knee_qps"] + 1e-9),
                       cell["curve"][-1] if cell["curve"] else {})
        print(f"{name.ljust(width)} {cell['knee_qps']:>9.0f} "
              f"{cell['knee_goodput_qps']:>8.0f} "
              f"{at_knee.get('p99_ms', float('nan')):>9.1f} "
              f"{at_knee.get('hbm_hit', float('nan')):>8.3f} "
              f"{at_knee.get('miss', float('nan')):>6.3f}", file=out)
    return out.getvalue()


def write(path: str, cells: Dict[str, Dict], spec: MatrixSpec,
          isolation: Dict = None) -> Tuple[str, str]:
    """Write ``BENCH_capacity.json`` and its sibling CSV; returns both
    paths."""
    data = headline(cells, spec, isolation)
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    csv_path = path.rsplit(".", 1)[0] + "_curves.csv"
    with open(csv_path, "w") as f:
        f.write(curves_csv(cells))
    return path, csv_path
