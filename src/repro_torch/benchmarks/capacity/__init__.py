# Copied from benchmarks/capacity/__init__.py (numpy-only): only module paths are renamed repro -> repro_torch, benchmarks -> repro_torch.benchmarks.
"""Capacity harness: trace-realistic workload matrix, knee-finding, and
committed latency–throughput curves.

The measurement substrate the ROADMAP's open items prove themselves on:
a declarative matrix runner over {offered QPS × sequence length ×
hosts/prefill-hosts × user-popularity skew × arrival process} producing
per-cell latency distributions, per-cell SLO knees (geometric-expansion
search — no hard QPS cap), and ``BENCH_capacity.json`` + CSV curves
committed next to ``BENCH_relay.json``.

    PYTHONPATH=src python -m repro_torch.benchmarks.capacity [--quick]

See ``benchmarks/capacity/README.md`` for the matrix schema.
"""

from .knee import HARD_CAP_QPS, KneeResult, find_knee
from .matrix import (ALL_MODES, COST, HSTU, ISO_BURST_QPS, N_INST, SIM_S,
                     SLO_MS, MatrixSpec, cell_name, isolation_cell,
                     meets_slo, mode_config, run_cell, run_matrix,
                     run_point, run_tenant_point)
from .report import PROVENANCE_FIELDS, curves_csv, headline, render, write
from .workload import DEFAULT_POPULATION, WorkloadSpec, fixed_stream

__all__ = [
    "ALL_MODES", "COST", "DEFAULT_POPULATION", "HARD_CAP_QPS", "HSTU",
    "ISO_BURST_QPS", "KneeResult", "MatrixSpec", "N_INST",
    "PROVENANCE_FIELDS", "SIM_S", "SLO_MS", "WorkloadSpec", "cell_name",
    "curves_csv", "find_knee", "fixed_stream", "headline",
    "isolation_cell", "meets_slo", "mode_config", "render", "run_cell",
    "run_matrix", "run_point", "run_tenant_point", "write",
]
