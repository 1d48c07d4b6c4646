"""The service layer's ONLY wall-clock access point.

Every timestamp the telemetry subsystem (and anything under
``repro_torch/service/``) reads comes through this module, never from
``time`` directly, as the reference package's lint rule OBS001 requires
of its own service and telemetry.

Two clocks:

* :func:`monotonic` / :func:`monotonic_ns` — interval measurement
  (span durations, fsync latency, overhead gates).  Never jumps.
* :func:`wall` — epoch seconds for human-facing timestamps in exported
  artifacts (metrics snapshots, trace metadata).  Never used to derive
  any computation.

Tests that need deterministic time install a fake via :func:`set_clock`
(restore with ``set_clock(None)``); the fake drives *both* monotonic and
wall readings so recorded spans stay internally consistent.
"""

from __future__ import annotations

import time as _time  # analysis: ignore[OBS001] - this IS the shim

from typing import Callable


class _FakeState:
    clock: Callable[[], float] | None = None


def set_clock(clock: Callable[[], float] | None) -> None:
    """Install a fake time source (seconds, float) for tests, or
    ``None`` to restore the real clocks."""
    _FakeState.clock = clock


def monotonic() -> float:
    """Seconds on a monotonically non-decreasing clock (intervals)."""
    if _FakeState.clock is not None:
        return _FakeState.clock()
    return _time.monotonic()


def monotonic_ns() -> int:
    """Nanoseconds on the monotonic clock (trace event timestamps)."""
    if _FakeState.clock is not None:
        return int(_FakeState.clock() * 1e9)
    return _time.monotonic_ns()


def wall() -> float:
    """Epoch seconds — labelling exported artifacts only."""
    if _FakeState.clock is not None:
        return _FakeState.clock()
    return _time.time()


def sleep(seconds: float) -> None:
    """Block for ``seconds`` — the service's only sleep primitive
    (retry backoff via :mod:`repro_torch.service.resilience`).
    Under a fake clock this returns immediately: fake time only moves
    when the test advances it, so a real block would deadlock."""
    if _FakeState.clock is not None:
        return
    _time.sleep(seconds)
