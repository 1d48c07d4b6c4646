"""The service's ONE retry/backoff/deadline policy (rule RES001).

Before this module, failure handling was scattered: ``max_restarts``
ints threaded into ``run_with_restarts`` call sites, bare ``timeout=``
floats on ``result``/``drain``, and no deadline concept at all — a
request whose wave kept failing simply hung its ticket.  This module
centralizes all of it:

* :class:`RetryPolicy` — capped exponential backoff with
  **deterministic jitter**: the jitter fraction is a pure function of
  ``(seed, counter, attempt)`` (the counter is the wave sequence
  number), so a replayed chaos run waits the exact same intervals —
  no wall-clock RNG, nothing to flake.
* :class:`Deadline` — a per-request time budget measured on the
  monotonic clock shim.  Retry sleeps are clamped to the remaining
  budget and an expired deadline stops the attempt loop with
  :class:`DeadlineExceeded` instead of burning the tail of the budget
  on a doomed retry.
* :func:`run_with_policy` — the one attempt loop.  Exhaustion raises
  :class:`RetryExhausted` (a ``RuntimeError`` carrying the attempt
  count, stage and last cause); the engine converts that into a
  structured :class:`~repro_torch.service.api.RequestFailed` result so a
  ticket *completes* with a diagnosis rather than hanging.

The reference package's lint rule RES001 enforces this centralization;
the port keeps to it: no module of ``repro_torch.service`` runs its own
retry loop or calls ``sleep``.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable

from repro_torch.obs import clock as _clock

# Re-exported so service code needs no direct fault_tolerance import.
from repro_torch.distributed.fault_tolerance import StepWatchdog  # noqa: F401

__all__ = ["RetryPolicy", "Deadline", "RetryExhausted",
           "DeadlineExceeded", "run_with_policy", "StepWatchdog"]


class RetryExhausted(RuntimeError):
    """Every attempt the policy allowed failed.

    Carries the diagnosis the engine folds into ``RequestFailed``:
    ``stage`` (which pipeline step), ``attempts`` (how many ran) and
    ``last`` (the final cause, also the ``__cause__``).
    """

    def __init__(self, stage: str, attempts: int, last: Exception):
        super().__init__(
            f"{stage} failed after {attempts} attempt"
            f"{'s' if attempts != 1 else ''}: "
            f"{type(last).__name__}: {last}")
        self.stage = stage
        self.attempts = attempts
        self.last = last


class DeadlineExceeded(TimeoutError):
    """A deadline budget ran out before the work completed."""


class Deadline:
    """A time budget anchored at construction (monotonic clock shim).

    ``budget=None`` means unbounded — ``remaining()`` is ``inf`` and
    the deadline never expires, so call sites need no None-branches.
    """

    def __init__(self, budget: float | None):
        if budget is not None and budget <= 0:
            raise ValueError("deadline budget must be positive (or None)")
        self.budget = None if budget is None else float(budget)
        self._t0 = _clock.monotonic()

    def remaining(self) -> float:
        if self.budget is None:
            return float("inf")
        return self.budget - (_clock.monotonic() - self._t0)

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def __repr__(self) -> str:
        if self.budget is None:
            return "Deadline(unbounded)"
        return f"Deadline({self.budget:g}s, {self.remaining():.3g}s left)"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with deterministic jitter.

    ``max_attempts`` counts *total* attempts (1 = never retry);
    the pre-retry-k sleep is ``backoff(k) = min(base_delay *
    multiplier**(k-1), max_delay)`` shrunk by a jitter fraction in
    ``[0, jitter)`` derived from ``(seed, counter, attempt)`` — jittered
    delays never exceed the capped backoff, and a replay with the same
    wave counter sleeps identically.
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_delay < 0 or self.max_delay < 0:
            raise ValueError("delays must be non-negative")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")

    def backoff(self, attempt: int) -> float:
        """Un-jittered delay before retry ``attempt`` (1-based):
        monotone non-decreasing in ``attempt``, capped at
        ``max_delay``."""
        if attempt < 1:
            raise ValueError("attempt is 1-based")
        return min(self.base_delay * self.multiplier ** (attempt - 1),
                   self.max_delay)

    def delay(self, attempt: int, counter: int = 0) -> float:
        """The actual (jittered) sleep before retry ``attempt``; in
        ``(backoff * (1 - jitter), backoff]`` and a pure function of
        ``(seed, counter, attempt)``."""
        b = self.backoff(attempt)
        return b * (1.0 - self.jitter * self._unit(attempt, counter))

    def _unit(self, attempt: int, counter: int) -> float:
        """Deterministic uniform-ish value in [0, 1)."""
        h = zlib.crc32(f"{self.seed}:{int(counter)}:{int(attempt)}"
                       .encode("ascii"))
        return (h & 0xFFFFFF) / float(1 << 24)


def run_with_policy(body: Callable[[int], object], policy: RetryPolicy, *,
                    stage: str = "wave", counter: int = 0,
                    deadline: Deadline | None = None,
                    on_retry: Callable[[int, Exception], None] | None = None):
    """Run ``body(attempt)`` under the policy; the service's only
    retry loop.

    ``on_retry`` is called with ``(attempt, exc)`` for every failed
    attempt (including the final one), mirroring the old
    ``run_with_restarts`` hook so telemetry events/counters stay
    comparable.  Exhaustion raises :class:`RetryExhausted`; an expired
    ``deadline`` raises :class:`DeadlineExceeded` *before* starting an
    attempt (a started attempt is never interrupted — waves must reach
    their deposit boundary or be retired whole).
    """
    last: Exception | None = None
    for attempt in range(policy.max_attempts):
        if deadline is not None and deadline.expired:
            raise DeadlineExceeded(
                f"{stage} deadline expired after {attempt} attempt"
                f"{'s' if attempt != 1 else ''} "
                f"(budget {deadline.budget:g}s)") from last
        try:
            return body(attempt)
        except Exception as exc:  # noqa: BLE001 - the policy IS the catch
            last = exc
            if on_retry is not None:
                on_retry(attempt, exc)
            if attempt + 1 >= policy.max_attempts:
                raise RetryExhausted(stage, attempt + 1, exc) from exc
            pause = policy.delay(attempt + 1, counter)
            if deadline is not None:
                pause = min(pause, max(deadline.remaining(), 0.0))
            if pause > 0:
                _clock.sleep(pause)
    raise RetryExhausted(stage, policy.max_attempts, last)  # unreachable
