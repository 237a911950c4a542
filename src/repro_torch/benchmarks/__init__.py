"""Benchmarks of the port.

Live, on the port's executors and kernels: ``calibrate`` (batch
factors), ``microbench`` and ``hardware`` (the H100 ``HardwareModel``
fitted to measured executor times).  Simulated, copies of the
reference's ``benchmarks/``: ``figures``, ``ablations``, ``capacity``,
``check_regression`` and the entry point ``run``.

Every output a benchmark writes by default goes under ``BUILD``, the
repository's gitignored ``build/``; the committed ``BENCH_*`` files at
the repository root are only read.
"""

from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
BUILD = ROOT / "build"
