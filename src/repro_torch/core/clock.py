# Copied from src/repro/core/clock.py (numpy-only): only module paths are renamed repro -> repro_torch.
"""Clock protocol for the relay-race runtime.

The canonical lifecycle state machine (repro_torch.core.runtime) is event-
driven; the only difference between live serving and cluster simulation
is which clock stamps and advances the timeline:

  * ``WallClock`` — live mode.  ``now()`` reads the host monotonic
    clock; ``advance()`` is a no-op because real time advances itself.
    Event timestamps come from request arrival times (caller-supplied
    or read off this clock) plus measured executor latencies.
  * ``VirtualClock`` — simulation mode.  Time is purely logical and the
    event loop advances it to each popped event's timestamp, so a
    12-second cluster trace replays in milliseconds of host time.

Anything satisfying the ``Clock`` protocol can drive the runtime (e.g.
a trace-replay clock that follows recorded production timestamps).
"""

from __future__ import annotations

import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    def now(self) -> float:
        """Current time in seconds (origin is clock-defined)."""
        ...

    def advance(self, t: float) -> None:
        """The event loop reached timestamp ``t``; logical clocks jump
        there, physical clocks ignore it."""
        ...


class WallClock:
    """Monotonic host clock anchored at construction (live mode)."""

    def __init__(self) -> None:
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def advance(self, t: float) -> None:  # real time cannot be steered
        pass


class VirtualClock:
    """Discrete-event logical clock (simulation mode)."""

    def __init__(self, start: float = 0.0) -> None:
        self._now = start

    def now(self) -> float:
        return self._now

    def advance(self, t: float) -> None:
        self._now = t
