# Copied from benchmarks/capacity/workload.py (numpy-only): only module paths are renamed repro -> repro_torch, benchmarks -> repro_torch.benchmarks.
"""Workload layer of the capacity harness: WHO arrives and WHEN.

``WorkloadSpec`` names one trace-realistic workload — a request
popularity law (uniform or Zipf over a multi-million-user population)
crossed with an arrival process (Poisson / diurnal sinusoid / MMPP
bursty) — and builds the timed ``(t, UserMeta)`` stream that feeds
``ClusterSim.run`` unchanged.  The samplers themselves live in
``repro_torch.data.synthetic`` (the data substrate); this module is the
benchmark-facing declarative surface.

``fixed_stream`` is the legacy uniform-draw generator lifted out of
``benchmarks/figures.py`` (which re-exports it): users drawn uniformly
from a billion ids, optional rapid-refresh repeats.  It remains the
back-compat reference workload — the one whose degenerate 100% hit
rates motivated this package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.types import UserMeta
from repro_torch.data.synthetic import (ARRIVAL_PROCESSES, ZipfPopularity,
                                  capacity_stream)

#: default request-popularity population (ids): multi-million, per the
#: paper's serving-scale workload description
DEFAULT_POPULATION = 2_000_000


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One named workload cell: popularity skew × arrival process.

    ``skew=0`` + ``arrival="poisson"`` reproduces the legacy uniform
    stream's statistics (over a finite population); ``skew>0`` makes a
    head of hot users recur within cache lifetimes, which is what lets
    hit-rate and tail-latency curves respond to footprint pressure.
    """
    skew: float = 0.0
    arrival: str = "poisson"
    population: int = DEFAULT_POPULATION
    arrival_kw: Optional[Dict] = None

    def __post_init__(self):
        if self.arrival not in ARRIVAL_PROCESSES:
            raise ValueError(f"unknown arrival process {self.arrival!r}; "
                             f"known: {sorted(ARRIVAL_PROCESSES)}")

    @property
    def name(self) -> str:
        """Stable cell label, e.g. ``zipf1.1-mmpp`` / ``uniform-poisson``."""
        pop = "uniform" if self.skew == 0 else f"zipf{self.skew:g}"
        return f"{pop}-{self.arrival}"

    def head_share(self, top: int = 100) -> float:
        """Analytic share of requests landing on the ``top`` hottest
        users — the report's head-heaviness label."""
        return ZipfPopularity(self.population, self.skew).cdf(top)

    def tail_share(self, top: int = 100) -> float:
        """Analytic share of requests from BEYOND the ``top`` hottest
        users — the tail traffic only the sub-DRAM tiers can keep warm."""
        return ZipfPopularity(self.population, self.skew).tail_share(top)

    def stream(self, L: int, qps: float, duration_s: float, *,
               seed: int = 0, dim: int = 256, n_items: int = 512,
               incr_len: int = 64) -> Iterator[Tuple[float, UserMeta]]:
        return capacity_stream(
            L, qps, duration_s, skew=self.skew, population=self.population,
            arrival=self.arrival, seed=seed, dim=dim, n_items=n_items,
            incr_len=incr_len, arrival_kw=self.arrival_kw)

    def to_dict(self) -> Dict:
        d = {"skew": self.skew, "arrival": self.arrival,
             "population": self.population}
        if self.arrival_kw:
            d["arrival_kw"] = dict(self.arrival_kw)
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "WorkloadSpec":
        return cls(skew=float(d.get("skew", 0.0)),
                   arrival=str(d.get("arrival", "poisson")),
                   population=int(d.get("population", DEFAULT_POPULATION)),
                   arrival_kw=d.get("arrival_kw"))


def fixed_stream(L, qps, dur, *, refresh=0.0, horizon=6000, seed=0,
                 dim=None, n_items=512) -> Iterable[Tuple[float, UserMeta]]:
    """Legacy benchmark stream (formerly ``figures._fixed_stream``):
    Poisson arrivals, users drawn uniformly from a billion ids, with
    probability ``refresh`` a repeat of one of the last ``horizon``
    users (the rapid-refresh knob that drives DRAM-tier reuse)."""
    rng = np.random.default_rng(seed)
    t, recent = 0.0, []
    while t < dur:
        t += rng.exponential(1.0 / qps)
        if recent and rng.random() < refresh:
            uid = int(rng.choice(recent[-horizon:]))
        else:
            uid = int(rng.integers(0, 10**9))
        recent.append(uid)
        yield t, UserMeta(user_id=uid, prefix_len=L, dim=dim or 256,
                          n_items=n_items)
