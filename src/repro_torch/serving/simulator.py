# Copied from src/repro/serving/simulator.py (numpy-only): only module paths are renamed repro -> repro_torch.
"""Discrete-event cluster simulator for RelayGR — runtime adapter.

The simulator is now a thin virtual-clock adapter over the canonical
event-driven state machine in ``repro_torch.core.runtime`` (``RelayRuntime``):
trigger admission, affinity routing, HBM window, expander single-flight,
M model slots and the bounded-concurrency PCIe channel all execute in
the runtime, identically to live mode — the simulator merely feeds it a
timed arrival stream under a ``VirtualClock`` so cluster-scale P99 /
throughput traces replay in milliseconds without real NPUs.  Per-
operation latencies come from ``repro_torch.core.costmodel`` via the ``sim``
executor, calibrated against the paper's reported component numbers.

``SimConfig`` and ``PipelineConfig`` remain importable here as
deprecation shims; new code should build a ``RelayConfig`` via
``repro_torch.core.runtime.relay_config``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Iterable, List, Tuple

from repro_torch.core.clock import VirtualClock
from repro_torch.core.costmodel import GRCostModel
from repro_torch.core.runtime import (ClusterConfig, PipelineConfig, Record,
                                RelayConfig, RelayRuntime, as_relay_config,
                                relay_config)
from repro_torch.core.trigger import TriggerConfig
from repro_torch.core.types import UserMeta

__all__ = ["ClusterSim", "PipelineConfig", "Record", "SimConfig", "run_sim"]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """DEPRECATED: use ``relay_config(trigger=..., cluster=...)``."""
    pipeline: PipelineConfig = PipelineConfig()
    trigger: TriggerConfig = TriggerConfig(n_instances=10)
    relay_enabled: bool = True           # False -> baseline
    dram_budget_bytes: float = 500e9
    hbm_cache_bytes: float = 16e9
    m_slots: int = 5
    pcie_concurrency: int = 4
    seed: int = 0

    def __post_init__(self):
        warnings.warn(
            "SimConfig is deprecated; build a RelayConfig with "
            "repro_torch.core.runtime.relay_config(trigger=..., cluster=...)",
            DeprecationWarning, stacklevel=3)

    def to_relay(self) -> RelayConfig:
        return relay_config(
            trigger=self.trigger, pipeline=self.pipeline,
            cluster=ClusterConfig(
                relay_enabled=self.relay_enabled,
                dram_budget_bytes=self.dram_budget_bytes,
                hbm_cache_bytes=self.hbm_cache_bytes,
                m_slots=self.m_slots,
                pcie_concurrency=self.pcie_concurrency,
                seed=self.seed))


class ClusterSim:
    """Virtual-clock adapter: replay a timed arrival stream through the
    shared relay-race runtime and report cluster-scale metrics."""

    def __init__(self, cfg, cost: GRCostModel, executor_factory=None):
        self.cfg = as_relay_config(cfg)
        self.runtime = RelayRuntime(self.cfg, cost, executor_factory,
                                    clock=VirtualClock())

    # --- adapter surface ----------------------------------------------------

    @property
    def instances(self) -> Dict:
        return self.runtime.instances

    @property
    def router(self):
        return self.runtime.router

    @property
    def topology(self):
        return self.runtime.topology

    @property
    def trigger(self):
        return self.runtime.trigger

    @property
    def special(self) -> List[str]:
        return self.runtime.special

    @property
    def normal(self) -> List[str]:
        return self.runtime.normal

    @property
    def records(self) -> List[Record]:
        return self.runtime.records

    @property
    def now(self) -> float:
        return self.runtime.now

    def run(self, arrivals: Iterable[Tuple[float, UserMeta]]
            ) -> Dict[str, float]:
        return self.runtime.run(arrivals)

    def summary(self) -> Dict[str, float]:
        return self.runtime.summary()


def run_sim(cfg, cost: GRCostModel,
            arrivals: Iterable[Tuple[float, UserMeta]]) -> Dict[str, float]:
    return ClusterSim(cfg, cost).run(arrivals)
