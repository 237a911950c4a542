"""The traced run: ``torch.profiler`` over the window, reduced to the
device's operations (kernels, copies and fills), its busy time, the top
operations and the longest idle gaps labelled by what the host was doing
(the harness's own ``relay.*`` ranges around each event it dispatches)."""

from __future__ import annotations

from typing import List, Tuple

import torch


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def intervals(prof) -> Tuple[list, list]:
    """(device operations, host ranges): lists of (name, start_us,
    end_us), each sorted by start."""
    kernels, host = [], []
    for ev in prof.events():
        name = ev.name
        t0, t1 = ev.time_range.start, ev.time_range.end
        if name.startswith("relay."):
            # a range of the harness's; kineto repeats it on the device's
            # timeline as an annotation, which is no device operation
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                host.append((name, t0, t1))
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((name, t0, t1))
    kernels.sort(key=lambda k: k[1])
    host.sort(key=lambda k: k[1])
    return kernels, host


def merged(kernels) -> List[Tuple[float, float]]:
    """The union of the kernels' intervals."""
    out: List[List[float]] = []
    for _, t0, t1 in kernels:
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def is_copy(name: str) -> bool:
    """A copy or fill, not a kernel (the profiler's ``Memcpy ...`` and
    ``Memset ...`` operations)."""
    return name.startswith(("Memcpy", "Memset"))


def busy_s(kernels) -> float:
    return sum(b - a for a, b in merged(kernels)) * 1e-6


def top_ops(kernels, n: int = 10) -> list:
    tot = {}
    for name, t0, t1 in kernels:
        tot[name] = tot.get(name, 0.0) + (t1 - t0) * 1e-6
    return sorted(([k, v] for k, v in tot.items()),
                  key=lambda kv: -kv[1])[:n]


def idle_gaps(kernels, host, w0: float, w1: float, n: int = 10) -> list:
    """The longest gaps between kernels inside [w0, w1] (us), each named
    by the host range that covers its midpoint (the innermost, latest
    started), ``host`` if none."""
    gaps, last = [], w0
    for a, b in merged(kernels):
        if a > last:
            gaps.append((last, min(a, w1)))
        last = max(last, b)
    if w1 > last:
        gaps.append((last, w1))
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    out = []
    for a, b in gaps[:n]:
        mid = (a + b) / 2
        names = [h for h in host if h[1] <= mid <= h[2]]
        label = max(names, key=lambda h: h[1])[0] if names else "host"
        out.append([label, (b - a) * 1e-6])
    return out
