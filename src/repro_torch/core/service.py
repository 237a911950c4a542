# Copied from src/repro/core/service.py (numpy-only): only module paths are renamed repro -> repro_torch.
"""RelayGR service: the live-mode adapter over the shared RelayRuntime.

The full retrieval -> pre-processing -> ranking relay for live serving:
``submit()`` injects a request into the canonical event-driven state
machine (repro_torch.core.runtime) and drains its cascade synchronously, so
live mode and the cluster simulator execute the *identical* lifecycle —
only the clock and the executor differ (see tests/test_runtime_parity).

The stage-level methods (``on_retrieval`` / ``deliver_pre_infer`` /
``on_rank``) remain for tests and ablations that drive the relay out of
band of the pipeline timing; they compose the same transition kernels.

``ServiceConfig`` is a deprecation shim — new code should build a
``RelayConfig`` via ``repro_torch.core.runtime.relay_config``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

from .clock import Clock, WallClock
from .costmodel import GRCostModel
from .runtime import (ClusterConfig, RelayConfig, RelayRuntime,
                      as_relay_config, relay_config)
from .trigger import TriggerConfig
from .types import RankResult, Request, UserMeta


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """DEPRECATED: use ``relay_config(trigger=..., cluster=...)``."""
    trigger: TriggerConfig = TriggerConfig()
    n_normal: int = 0                  # 0 -> derived from trigger cfg
    hbm_cache_bytes: float = 16e9
    dram_budget_bytes: float = 500e9
    long_seq_threshold: int = 0        # 0 -> use the trigger's risk test
                                       # (pre-processing decides the service)

    def __post_init__(self):
        warnings.warn(
            "ServiceConfig is deprecated; build a RelayConfig with "
            "repro_torch.core.runtime.relay_config(trigger=..., cluster=...)",
            DeprecationWarning, stacklevel=3)

    def to_relay(self) -> RelayConfig:
        return relay_config(
            trigger=self.trigger,
            cluster=ClusterConfig(
                n_normal=self.n_normal,
                hbm_cache_bytes=self.hbm_cache_bytes,
                dram_budget_bytes=self.dram_budget_bytes,
                long_seq_threshold=self.long_seq_threshold))


class RelayGRService:
    def __init__(self, cfg, cost: GRCostModel, executor_factory=None,
                 clock: Optional[Clock] = None):
        self.cfg = as_relay_config(cfg)
        self.cost = cost
        self.runtime = RelayRuntime(self.cfg, cost, executor_factory,
                                    clock=clock or WallClock())

    # --- adapter surface (state lives on the shared runtime) -------------------

    @property
    def trigger(self):
        return self.runtime.trigger

    @property
    def router(self):
        return self.runtime.router

    @property
    def topology(self):
        return self.runtime.topology

    def host_join(self, n_special: int = 1, n_normal: int = 0,
                  now: Optional[float] = None):
        return self.runtime.host_join(n_special, n_normal, now=now)

    def host_leave(self, name: str, now: Optional[float] = None) -> None:
        self.runtime.host_leave(name, now=now)

    @property
    def instances(self) -> Dict:
        return self.runtime.instances

    @property
    def slo(self):
        return self.runtime.slo

    @property
    def special_names(self):
        return self.runtime.special

    @property
    def normal_names(self):
        return self.runtime.normal

    # --- stage 1: retrieval side-path ----------------------------------------
    def on_retrieval(self, meta: UserMeta, now: float
                     ) -> Optional[Request]:
        """Trigger assessment; returns the auxiliary pre-infer signal if
        the request was admitted (caller/simulator delivers it)."""
        signal, _target = self.runtime.open_lifecycle(meta, now)
        return signal

    def deliver_pre_infer(self, signal: Request, now: float
                          ) -> Dict[str, float]:
        inst = self.instances[signal.body["target"]]
        return inst.handle_pre_infer(signal, now)

    # --- stage 3: fine-grained ranking ----------------------------------------
    def on_rank(self, meta: UserMeta, now: float) -> RankResult:
        req, target = self.runtime.bind_rank(meta, now)
        result = self.instances[target].handle_rank(req, now)
        self.slo.observe(now=now, e2e_ms=result.latency_ms,
                         hit=result.hit.value,
                         components=result.components)
        return result

    # --- synchronous end-to-end (live mode / tests) ----------------------------
    def submit(self, meta: UserMeta, now: Optional[float] = None
               ) -> RankResult:
        """Run one request through the full event-driven lifecycle
        (admission at arrival, pre-infer on the side path, ranking after
        the retrieval/preprocess slack).  ``latency_ms`` always equals
        ``sum(components.values())``."""
        return self.runtime.submit(meta, now)

    # --- observability -----------------------------------------------------------
    def stats(self) -> Dict[str, Dict]:
        return self.runtime.stats()
