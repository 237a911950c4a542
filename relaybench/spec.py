"""Find a cell's configuration, traffic mix and metrics by name.

``BENCHMARK.json`` names a cell's configuration and traffic; their data
sit in ``configs/<name>.json`` and ``traffic/<name>.json``, and every
metric is a reader in ``metrics/<metric name>.py`` with a function
``read(run)`` that returns a number, or None where it finds nothing to
read.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                   f"have {[w['name'] for w in bench['workloads']]}")


def metrics_of(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: the cell's end-to-end
    metrics with ``--trace 0``; with ``--trace 1`` its per-layer ones,
    each listed for the cell or (without a ``workloads`` key) moving an
    end-to-end metric the cell reports."""
    def listed(m: dict) -> bool:
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py`` (names may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"relaybench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader found
    something to read."""
    out: Dict[str, dict] = {}
    for m in metrics:
        value: Optional[float] = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
