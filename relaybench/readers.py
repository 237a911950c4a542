"""Arithmetic the metric readers (``metrics/*.py``) share.  Every reader
is ``read(run) -> number or None``; None where the run holds nothing to
read (a share of a roofline or a peak is never reported as 0 for lack of
data)."""

from __future__ import annotations

import math
import re
from typing import List, Optional

from relaybench import flops

KERNEL = re.compile(r"hstu_rank_attn_kernel<\s*\d+,\s*(true|false),\s*"
                    r"(true|false)")


def percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 1]); None for no values."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def rank_latency_ms(run) -> List[float]:
    """Every window request's rank latency, due time to scores on the
    host; a request never answered counts as infinitely late."""
    return [(q["done"] - q["due"]) * 1e3 if q["done"] is not None
            else math.inf for q in run.requests]


def finite(x: Optional[float]) -> Optional[float]:
    return x if x is not None and math.isfinite(x) else None


def delta(run, key: str) -> Optional[float]:
    o, c = run.counters.get("open"), run.counters.get("close")
    if not o or not c:
        return None
    return c[key] - o[key]


def ratio(num: Optional[float], den: Optional[float]) -> Optional[float]:
    if num is None or not den:
        return None
    return num / den


def window_launches(run) -> list:
    return [l for l in run.launches if run.t_open <= l["t0"] < run.t_close]


def model_flops(run) -> Optional[float]:
    """Model FLOPs of the window's pre-infers and ranks, at the served
    shapes: a pre-infer member over its prefill length, a hit's rank
    over its resident prefix, a full rank's prefill and rank over its
    bucket (batch rows that repeat a member are not counted)."""
    c = run.cfg["model"]
    inc, items = run.traffic["incr_len"], run.traffic["n_items"]
    total = 0
    ls = window_launches(run)
    for l in ls:
        for n in l["members"]:
            if l["kind"] == "pre":
                total += flops.prefill_flops(c, n)
            elif l["kind"] == "paged":
                total += flops.rank_flops(c, n, inc, items)
            else:
                total += (flops.prefill_flops(c, n)
                          + flops.rank_flops(c, n, inc, items))
    return total if ls else None


def mfu(run) -> Optional[float]:
    """Model FLOPs over the window's seconds over the peak, in %."""
    fl = model_flops(run)
    if fl is None:
        return None
    peak = flops.PEAK_FLOPS[run.cfg["model"]["dtype"]]
    return 100.0 * fl / (run.seconds * peak)


def kernel_seconds(run, paged: bool) -> float:
    want = "true" if paged else "false"
    return sum((t1 - t0) * 1e-6 for name, t0, t1 in run.kernels
               if (m := KERNEL.search(name)) and m.group(1) == want
               and m.group(2) == "false")


def bound_seconds(run, paged: bool) -> float:
    """The least time the window's launches of the dense (causal
    prefill and dense rank) or the paged rank kernel could take: per
    launch and layer max(FLOPs / peak, bytes / bandwidth)."""
    c = run.cfg["model"]
    inc, items = run.traffic["incr_len"], run.traffic["n_items"]
    total = 0.0
    for l in window_launches(run):
        rows, n = l["rows"], l["n"]
        if paged and l["kind"] == "paged":
            total += flops.bound_s(c, *flops.rank_kernel(
                c, l["rows_prefix"], inc, items))
        elif not paged and l["kind"] == "pre":
            total += flops.bound_s(c, *flops.causal_kernel(c, rows, n))
        elif not paged and l["kind"] == "full":
            total += flops.bound_s(c, *flops.causal_kernel(c, rows, n))
            total += flops.bound_s(c, *flops.rank_kernel(
                c, [n] * rows, inc, items))
    return total * c["n_layers"]


def roofline(run, paged: bool) -> Optional[float]:
    """The kernel's share of its roofline over the window, in %."""
    t = kernel_seconds(run, paged)
    b = bound_seconds(run, paged)
    if not t or not b:
        return None
    return 100.0 * b / t


def idle_share(run) -> Optional[float]:
    """Share of the traced window with no kernel running (copies and
    fills count as idle), in %."""
    if not run.window_s or run.kernel_busy_s is None:
        return None
    return 100.0 * (1.0 - run.kernel_busy_s / run.window_s)


def batch_mean(run) -> Optional[float]:
    return ratio(delta(run, "rank_requests"), delta(run, "rank_batches"))
