# Copied from benchmarks/capacity/knee.py (numpy-only): only module paths are renamed repro -> repro_torch, benchmarks -> repro_torch.benchmarks.
"""Knee-finding: the largest offered QPS whose measured run still meets
an SLO criterion — the x-location of the latency–throughput curve's
knee, and the scalar every mode is gated on in CI.

The search is shared by the capacity matrix and the legacy figure
harness (``repro_torch.benchmarks.figures._max_qps`` is a thin wrapper).  It
replaces the old hard ``hi=1200`` bisection cap with *geometric
upper-bound expansion*: the upper probe doubles until the criterion
fails (or an explicit ``hard_cap`` backstop is reached), so future
throughput gains are never silently clipped at a constant that was
sized for last year's runtime.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

#: absolute backstop for the geometric expansion — only a guard against
#: a degenerate criterion that never fails (e.g. an empty stream); any
#: real deployment saturates long before this
HARD_CAP_QPS = 1e6


@dataclasses.dataclass
class KneeResult:
    """Outcome of one knee search."""
    best: float                 # criterion-key value at the knee (0 if none)
    knee_qps: float             # largest offered QPS that passed
    probes: List[Tuple[float, bool, Dict]]  # (offered_qps, ok, summary)
    hard_cap: float = HARD_CAP_QPS

    @property
    def capped(self) -> bool:
        """True iff the expansion hit the ``hard_cap`` backstop while
        still passing — the measured knee is a lower bound, not a
        knee."""
        return bool(self.probes) and self.probes[-1][1] \
            and self.probes[-1][0] >= self.hard_cap


def find_knee(measure: Callable[[float], Dict],
              criterion: Callable[[Dict], bool], *,
              lo: float = 5.0, hi: Optional[float] = None,
              key: str = "goodput_qps", coarse: bool = False,
              hard_cap: float = HARD_CAP_QPS) -> KneeResult:
    """Bisect for the largest offered QPS meeting ``criterion``.

    ``measure(qps)`` runs one experiment and returns its summary dict;
    ``criterion(summary)`` decides pass/fail; the returned ``best`` is
    ``summary[key]`` at the highest passing probe (goodput under the
    pipeline-SLO criterion, raw throughput under stage-budget ones).

    ``hi`` seeds the upper probe (default ``32·lo``).  A passing upper
    probe is *expanded geometrically* (doubled) until the criterion
    fails, so the search brackets the knee wherever it is;  ``coarse``
    widens the bisection tolerance (used by --quick CI smoke runs).
    """
    best, knee = 0.0, 0.0
    probes: List[Tuple[float, bool, Dict]] = []

    def probe(q: float) -> bool:
        nonlocal best, knee
        s = measure(q)
        ok = bool(criterion(s))
        probes.append((q, ok, s))
        if ok and q > knee:
            best, knee = float(s.get(key, 0.0)), q
        return ok

    hi = float(hi) if hi is not None else max(32.0 * lo, 160.0)
    # geometric upper-bound expansion: double until the criterion fails
    while hi < hard_cap and probe(hi):
        lo, hi = hi, min(hi * 2.0, hard_cap)
    if hi >= hard_cap and (not probes or probes[-1][1]):
        # degenerate: even the backstop passes — report it as capped
        probe(hard_cap)
        return KneeResult(best=best, knee_qps=knee, probes=probes,
                          hard_cap=hard_cap)
    if not any(ok for _, ok, _ in probes):
        # the seed upper probe failed outright: ground the bracket by
        # probing lo itself — otherwise bisection narrows toward an
        # UNVERIFIED lower bound and can report knee_qps=0/best=0 with
        # no evidence that lo fails (every mid probe may fail while lo
        # would have passed)
        if not probe(lo):
            return KneeResult(best=best, knee_qps=knee, probes=probes,
                              hard_cap=hard_cap)
    slack = 0.30 if coarse else 0.08
    while hi - lo > max(4.0, lo * slack):
        mid = (lo + hi) / 2.0
        if probe(mid):
            lo = mid
        else:
            hi = mid
    return KneeResult(best=best, knee_qps=knee, probes=probes,
                      hard_cap=hard_cap)
