"""FLOP accounting of one step for the roofline (port of
``repro.launch.flops``).

``step_flops`` runs the step once under ``torch.utils.flop_counter.
FlopCounterMode`` and returns the FLOPs of its matmul-family and
convolution ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``, attention,
convolution, forward and backward): what the reference counts of a
jaxpr (``dot_general`` and ``conv_general_dilated``), elementwise ops
ignored.  Every op that runs is counted, so per-layer loops, chunked
loops, the recompute of ``torch.utils.checkpoint`` and the backward are
counted as executed.

Run on ``meta`` tensors (a model built with ``device="meta"`` and
``launch.steps.step_inputs(..., "meta")``) nothing is computed or
allocated, and the kernel wrappers run their plain twins
(``kernels.ref.runs_plain``), so the count is that of the plain math at
any size.  RWKV6's WKV recurrence, a Python loop over time, counts on
meta as one batched product of the loop's sizes
(``models.ssm._rwkv_wkv_scan``), so a full-length record takes seconds.
"""

from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode


def step_flops(fn, args) -> int:
    """Total (global, unpartitioned) matmul and convolution FLOPs of
    ``fn(*args)``."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()
