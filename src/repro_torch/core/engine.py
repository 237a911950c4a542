# Copied from src/repro/core/engine.py (numpy-only): only module paths are renamed repro -> repro_torch.
"""Compatibility layer for the pre-runtime engine API.

The ranking-instance state machine that used to live here is now the
single source of truth in ``repro_torch.core.runtime`` (``InstanceRuntime``),
and the executors moved to ``repro_torch.core.executors`` (protocol +
registry).  This module keeps the historical import surface working:

    from repro_torch.core.engine import RankingInstance, SimExecutor, ...

``RankingInstance`` *is* ``InstanceRuntime`` — the same object the
event-driven runtime schedules — so manually-driven instances (tests,
ablations, churn experiments) and pipeline-driven ones share one
implementation.
"""

from __future__ import annotations

from .executors import (Executor, LiveExecutor, SimExecutor, get_executor,
                        register_executor)
from .runtime import InstanceConfig, InstanceRuntime

RankingInstance = InstanceRuntime

__all__ = ["Executor", "InstanceConfig", "InstanceRuntime", "LiveExecutor",
           "RankingInstance", "SimExecutor", "get_executor",
           "register_executor"]
