"""Benchmark of ``repro_torch``'s relay serve path on one NVIDIA H100.

``python3 relaybench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Each configuration, traffic mix and metric is a file of its
own under ``configs/``, ``traffic/`` and ``metrics/``, found by name.
Nothing here imports ``jax`` or the JAX package ``repro``.
"""
