"""Live benchmarks of the port (``calibrate``, ``microbench``): what the
reference's ``benchmarks/calibrate.py`` and ``benchmarks/microbench.py``
measure, on the port's executors and kernels."""
