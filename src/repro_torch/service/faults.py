"""Deterministic fault injection for the wave pipeline (chaos harness).

The service promises that the STR001-006 invariants — bit-identical
resume, gap-free folds, disjoint counter ranges — survive a failure at
*any* pipeline stage.  Happy-path tests cannot prove that; this module
makes the failure part of the test input.  A :class:`FaultPlan` is a
set of **counted-down trigger points**: each fault point carries the
0-based hit index at which its hook fires, so "the third wal fsync
fails" is a pure function of the plan, reproducible from a seed across
processes and CI reruns.

Fault points (see :data:`FAULT_POINTS`):

* the six trace stages — ``plan``, ``launch``, ``device_execute``,
  ``transfer``, ``deposit``, ``wal_commit`` — each modeling a crash at
  that stage of a wave (raises :class:`InjectedCrash`);
* ``wal_fsync`` — the journal write's fsync fails with
  :class:`InjectedIOError` (ENOSPC / dying disk) *after* the bytes hit
  the file, exercising the store's fail-closed rewind;
* ``wal_torn_write`` — only a prefix of the record reaches the file
  before the error, modeling a torn write at the kill instant;
* ``device_error`` — a launch group's dispatch raises
  :class:`InjectedDeviceError` (lost accelerator);
* ``transfer_nan`` — one deposit's transferred sums are poisoned to
  NaN, exercising the cache's finite checks and quarantine ladder;
* ``worker_crash`` — the engine's background worker thread dies at a
  wave boundary (state is salvaged; a driver can resume via ``step()``).

Hooks are threaded through :mod:`repro_torch.service.store`,
:mod:`repro_torch.service.cache`, :mod:`repro_torch.service.batcher` and
:mod:`repro_torch.service.engine`; every call site holds :data:`NULL_FAULTS`
by default, whose hooks are constant-return no-ops — an engine without
a plan pays one attribute test per hook, nothing else.

Every fired fault is recorded (``plan.fired``) and counted into
``zmc_faults_injected_total{stage=...}`` once the plan is bound to an
:class:`~repro_torch.obs.Observability` bundle, so the chaos bench can assert
the injected set *exactly* against the metrics contract.
"""

from __future__ import annotations

import threading
import zlib
from typing import Mapping, Sequence

from repro_torch.obs.trace import STAGES

# Every trigger point a FaultPlan may name.
FAULT_POINTS: tuple[str, ...] = STAGES + (
    "wal_fsync", "wal_torn_write", "device_error", "transfer_nan",
    "worker_crash")


class InjectedFault(Exception):
    """Mixin marking an exception as deliberately injected chaos."""


class InjectedCrash(InjectedFault, RuntimeError):
    """A stage-level crash (plan/launch/transfer/... or worker death)."""


class InjectedDeviceError(InjectedFault, RuntimeError):
    """A lost/odd accelerator at dispatch time."""


class InjectedIOError(InjectedFault, OSError):
    """A failed journal write or fsync (ENOSPC, dying disk)."""


class NullFaultPlan:
    """The default: injection disabled, hooks constant no-ops."""

    enabled = False

    def bind(self, obs) -> "NullFaultPlan":
        return self

    def fire(self, point: str) -> bool:
        return False

    def check(self, point: str) -> None:
        return None


NULL_FAULTS = NullFaultPlan()


class FaultPlan:
    """Counted-down fault triggers, replayable from ``(seed, points)``.

    ``triggers`` maps fault-point names to the 0-based hit index at
    which the hook fires (or a collection of indices to fire several
    times).  Hit counting is per point and thread-safe; the plan is
    exhausted once every trigger has fired.  Exception *types* are
    fixed per point (see the module docstring), so a caller's retry
    policy sees exactly what the real failure would raise.
    """

    enabled = True

    def __init__(self, triggers: Mapping[str, int | Sequence[int]]):
        self.triggers: dict[str, frozenset[int]] = {}
        for point, at in dict(triggers).items():
            if point not in FAULT_POINTS:
                raise ValueError(
                    f"unknown fault point {point!r}; valid points: "
                    f"{', '.join(FAULT_POINTS)}")
            hits = (at,) if isinstance(at, int) else tuple(at)
            if any(h < 0 for h in hits):
                raise ValueError(f"trigger indices must be >= 0: {hits}")
            self.triggers[point] = frozenset(hits)
        self.hits: dict[str, int] = dict.fromkeys(self.triggers, 0)
        self.fired: list[tuple[str, int]] = []
        self.obs = None
        self._lock = threading.Lock()

    @classmethod
    def from_seed(cls, seed: int, points: Sequence[str],
                  max_countdown: int = 4) -> "FaultPlan":
        """One trigger per point, its hit index derived from ``seed`` —
        the same seed always reproduces the same plan."""
        return cls({
            p: zlib.crc32(f"{int(seed)}:{p}".encode()) % int(max_countdown)
            for p in points})

    def spec(self) -> dict:
        """JSON-able description of the plan (bench artifacts, replay)."""
        return {p: sorted(hits) for p, hits in sorted(self.triggers.items())}

    def bind(self, obs) -> "FaultPlan":
        """Attach the telemetry bundle that counts fired faults."""
        self.obs = obs
        return self

    def fire(self, point: str) -> bool:
        """Count one hit of ``point``; True when this hit is a trigger.

        Call sites that need a *behavior* (poison values, tear a write)
        branch on the return; call sites that need an *exception* use
        :meth:`check`.
        """
        hits = self.triggers.get(point)
        if hits is None:
            return False
        with self._lock:
            k = self.hits[point]
            self.hits[point] = k + 1
            if k not in hits:
                return False
            self.fired.append((point, k))
        if self.obs is not None:
            self.obs.m["faults_injected"].inc(stage=point)
            self.obs.event("fault_injected", point=point, hit=k)
        return True

    def check(self, point: str) -> None:
        """Raise this point's exception type if its trigger fires."""
        if not self.fire(point):
            return
        if point in ("wal_fsync", "wal_torn_write"):
            import errno
            raise InjectedIOError(errno.ENOSPC,
                                  f"injected {point} failure")
        if point == "device_error":
            raise InjectedDeviceError("injected device error at dispatch")
        raise InjectedCrash(f"injected crash at {point}")

    @property
    def exhausted(self) -> bool:
        """True once every configured trigger has fired."""
        with self._lock:
            fired = {(p, k) for p, k in self.fired}
        return all((p, k) in fired
                   for p, hits in self.triggers.items() for k in hits)
