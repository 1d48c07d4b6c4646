"""Fault tolerance for the integration driver: restart-on-exception and
a step watchdog (port of the framework-free part of
``repro.distributed.fault_tolerance``).

* :func:`run_with_restarts` wraps a driver body; on any exception it
  calls the body again (which resumes from its checkpoint), up to a
  restart budget.  MC counters are pure functions of the sample index,
  so a restart replays the identical computation.
* :class:`StepWatchdog` tracks a running median of step time and records
  a :class:`StragglerEvent` for steps slower than ``threshold x median``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float


class StepWatchdog:
    """Flags steps slower than ``threshold`` x running median."""

    def __init__(self, threshold: float = 3.0, window: int = 32,
                 warmup: int = 3):
        self.threshold = threshold
        self.window = window
        self.warmup = warmup
        self.durations: list[float] = []
        self.events: list[StragglerEvent] = []
        self._t0: float | None = None
        self._step = 0

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        dt = time.monotonic() - self._t0
        hist = self.durations[-self.window:]
        if len(hist) >= self.warmup:
            med = float(np.median(hist))
            if dt > self.threshold * med:
                self.events.append(StragglerEvent(self._step, dt, med))
        self.durations.append(dt)
        self._step += 1
        return False

    @property
    def straggler_count(self) -> int:
        return len(self.events)


def run_with_restarts(body: Callable[[int], Any], *, max_restarts: int = 3,
                      on_restart: Callable[[int, Exception], None] | None = None):
    """Run ``body(attempt)`` with restart-on-exception semantics.

    ``body`` restores from its checkpoint at entry.  Returns its result;
    re-raises the last exception once the budget is spent.
    """
    for attempt in range(max_restarts + 1):
        try:
            return body(attempt)
        except Exception as e:  # noqa: BLE001 - driver-level catch is the point
            if on_restart is not None:
                on_restart(attempt, e)
            if attempt == max_restarts:
                raise
    raise AssertionError("unreachable")
