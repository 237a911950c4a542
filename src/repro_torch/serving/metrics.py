# Copied from src/repro/serving/metrics.py (numpy-only): only module paths are renamed repro -> repro_torch.
"""Streaming serving metrics: P² quantile estimation + windowed counters.

Production SLO enforcement needs online tail estimates without storing
every sample.  The P² algorithm (Jain & Chlamtac, 1985) maintains a
target quantile with five markers in O(1) per observation; `SLOTracker`
wraps one estimator per latency component plus success/QPS counters and
exports the same summary dict shape as the simulator — so the live
engine, the simulator and the benchmarks share observability plumbing.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List, Optional


class P2Quantile:
    """Single-quantile P² estimator (five-marker)."""

    def __init__(self, q: float = 0.99):
        self.q = q
        self._init: List[float] = []
        self.n = [0, 1, 2, 3, 4]
        self.ns = [0.0, 2 * q, 4 * q, 2 + 2 * q, 4.0]
        self.dns = [0.0, q / 2, q, (1 + q) / 2, 1.0]
        self.heights: List[float] = []
        self.count = 0

    def add(self, x: float):
        self.count += 1
        if len(self._init) < 5:
            self._init.append(x)
            if len(self._init) == 5:
                self._init.sort()
                self.heights = list(self._init)
            return
        h = self.heights
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            self.n[i] += 1
        for i in range(5):
            self.ns[i] += self.dns[i]
        for i in (1, 2, 3):
            d = self.ns[i] - self.n[i]
            if ((d >= 1 and self.n[i + 1] - self.n[i] > 1)
                    or (d <= -1 and self.n[i - 1] - self.n[i] < -1)):
                s = 1 if d >= 0 else -1
                hp = self._parabolic(i, s)
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:
                    h[i] = h[i] + s * (h[i + s] - h[i]) \
                        / (self.n[i + s] - self.n[i])
                self.n[i] += s

    def _parabolic(self, i: int, s: int) -> float:
        h, n = self.heights, self.n
        return h[i] + s / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + s) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - s) * (h[i] - h[i - 1]) / (n[i] - n[i - 1]))

    @property
    def value(self) -> float:
        if not self.heights:
            srt = sorted(self._init)
            if not srt:
                return float("nan")
            idx = min(int(self.q * len(srt)), len(srt) - 1)
            return srt[idx]
        return self.heights[2]


class WindowRate:
    """Completed-requests-per-second over a sliding time window."""

    def __init__(self, window_s: float = 10.0):
        self.window_s = window_s
        self._times: deque = deque()

    def mark(self, now: float):
        self._times.append(now)
        cut = now - self.window_s
        while self._times and self._times[0] < cut:
            self._times.popleft()

    def rate(self, now: float) -> float:
        cut = now - self.window_s
        while self._times and self._times[0] < cut:
            self._times.popleft()
        return len(self._times) / self.window_s


@dataclasses.dataclass
class SLOTracker:
    slo_ms: float = 135.0
    quantile: float = 0.99

    def __post_init__(self):
        self.e2e = P2Quantile(self.quantile)
        self.components = {k: P2Quantile(self.quantile)
                           for k in ("pre", "load", "rank", "queue")}
        self.rate = WindowRate()
        self.total = 0
        self.ok = 0
        self.hits: Dict[str, int] = {}

    def observe(self, *, now: float, e2e_ms: float, hit: str,
                components: Optional[Dict[str, float]] = None):
        self.total += 1
        self.ok += e2e_ms <= self.slo_ms
        self.e2e.add(e2e_ms)
        self.rate.mark(now)
        self.hits[hit] = self.hits.get(hit, 0) + 1
        for k, v in (components or {}).items():
            if k in self.components:
                self.components[k].add(v)

    def summary(self, now: float) -> Dict[str, float]:
        n = max(self.total, 1)
        out = {
            "n": self.total,
            "p99_ms": self.e2e.value,
            "success_rate": self.ok / n,
            "throughput_qps": self.rate.rate(now),
        }
        for k, est in self.components.items():
            out[f"{k}_p99_ms"] = est.value
        for k, v in self.hits.items():
            out[f"hit_{k}"] = v / n
        return out
