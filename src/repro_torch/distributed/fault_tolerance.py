"""Fault tolerance for the integration driver: restart-on-exception, a
step watchdog and a re-issuable work queue (port of
``repro.distributed.fault_tolerance``).

* :func:`run_with_restarts` wraps a driver body; on any exception it
  calls the body again (which resumes from its checkpoint), up to a
  restart budget.  MC counters are pure functions of the sample index,
  so a restart replays the identical computation.
* :class:`StepWatchdog` tracks a running median of step time and records
  a :class:`StragglerEvent` for steps slower than ``threshold x median``.
* :class:`WorkQueue` hands out (sample_offset, n_samples) chunks and puts
  a failed worker's chunk back at the front: counters make any chunk
  recomputable by any worker.
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


class WorkQueue:
    """Re-issuable chunk queue for the MC engine (counter-addressed work).

    Chunks are (sample_offset, n_samples) ranges; because the RNG is
    counter-based, *any* worker can (re)compute any chunk at any time and
    the merged result is independent of who computed what.
    """

    def __init__(self, total_samples: int, chunk: int):
        self.chunk = chunk
        self.pending: list[tuple[int, int]] = [
            (off, min(chunk, total_samples - off))
            for off in range(0, total_samples, chunk)]
        self.in_flight: dict[int, tuple[int, int]] = {}
        self.done: list[tuple[int, int]] = []
        self._next_ticket = 0

    def take(self) -> tuple[int, tuple[int, int]] | None:
        """The next pending chunk and its ticket, or None when none is
        pending."""
        if not self.pending:
            return None
        item = self.pending.pop(0)
        ticket = self._next_ticket
        self._next_ticket += 1
        self.in_flight[ticket] = item
        return ticket, item

    def complete(self, ticket: int) -> None:
        self.done.append(self.in_flight.pop(ticket))

    def fail(self, ticket: int) -> None:
        """Worker died: its chunk goes back to the front of pending."""
        self.pending.insert(0, self.in_flight.pop(ticket))

    @property
    def finished(self) -> bool:
        return not self.pending and not self.in_flight
