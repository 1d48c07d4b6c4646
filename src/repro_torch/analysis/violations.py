"""The one violation currency every analysis layer trades in (port of
``repro.analysis.violations``).

A :class:`Violation` is a rule ID plus a location plus a message.  Rule
IDs are stable, greppable, documented in :data:`RULES` and the same as
the reference package's, so one ID names one invariant in both trees.
Formatting is uniform (``RULE path:line message``) so a failing CI job
reads like a compiler error list.

The reference's BND001 and BND002 guard jax's version drift (its two
compat shims).  The port has no jax, so it keeps their IDs for the
port's own boundaries: BND001 is an import of ``jax`` or of the
reference package ``repro`` anywhere in ``repro_torch``, BND002 loading
a built kernel library or running ``nvcc`` outside
``repro_torch/kernels/build.py``.  KCT001's subject is the eval body's
recorded op stream instead of a jaxpr.

This module is dependency-free (no torch, no numpy): the lint and the
journal auditor run in processes that never touch a device.
"""

from __future__ import annotations

import dataclasses

# Rule registry: ID -> one-line contract it enforces.  Layer 1 (AST
# lint) rules are prefixed BND/PUR/F64/OBS/RES, Layer 2 (eval-body
# contracts) KCT, Layer 3 (durable-state determinism) STR.
RULES: dict[str, str] = {
    "BND001": ("repro_torch imports neither jax nor the reference package "
               "repro (the port keeps its own copy of what it needs)"),
    "BND002": ("built kernel libraries are loaded (ctypes.CDLL) and nvcc "
               "is run only from repro_torch/kernels/build.py"),
    "PUR001": ("no wall-clock, stateful RNG or host I/O inside "
               "repro/kernels/ or repro/core/ modules"),
    "F64001": ("no float64 on kernel/core accumulator paths (TPU MC "
               "reductions are f32-only)"),
    "OBS001": ("service/obs layers read the wall clock only through "
               "repro/obs/clock.py (one shim: fake-clock tests and "
               "trace timestamps stay consistent)"),
    "RES001": ("service-layer retries, backoff sleeps and deadlines go "
               "only through repro/service/resilience.py (no ad-hoc "
               "run_with_restarts or .sleep() calls: one policy, "
               "deterministic jitter, budget-aware)"),
    "KCT001": ("kernel eval bodies must run side-effect free on probe "
               "operands (no host sync, no copy off the device, no "
               "random op)"),
    "KCT002": ("kernel eval bodies must accumulate in float32 — the "
               "(s1, s2) deposit dtype the WAL replays bit-exactly"),
    "KCT003": ("all bodies sharing a (dim, sampler) bucket must produce "
               "identical output avals (the lax.switch precondition)"),
    "KCT004": ("forms advertising supports_compactified=True must trace "
               "through template.compactified_body"),
    "KCT005": ("forms advertising sweep capability (sweep_cols) must "
               "trace through template.swept_body"),
    "KCT006": ("forms advertising supports_adapted=True must trace "
               "through template.adapted_body (the VEGAS importance-map "
               "stage)"),
    "STR001": ("cached streams own pairwise-disjoint counter-space "
               "ranges"),
    "STR002": ("per-stream deposit rounds are gap-free and monotone "
               "(the in-order left-fold bit-identity precondition)"),
    "STR003": ("deposit deltas are shape- and size-consistent with the "
               "stream's allocation and round quantum"),
    "STR004": ("the allocator high-water mark covers every allocated "
               "counter range"),
    "STR005": ("meta.json, snapshot and alloc records agree on the "
               "round quantum"),
    "STR006": ("every deposit references an allocated stream (a dep "
               "without its alloc is dropped on replay)"),
    "STR007": ("adapted-stream grid epochs form a contiguous chain — "
               "each grid record's epoch extends its parent by one, "
               "duplicate children agree, and the grid record precedes "
               "the child stream's alloc in the journal"),
}


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken invariant at one location."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.rule} {self.path}:{self.line} {self.message}"


def render(violations) -> str:
    """Stable, sorted, one-per-line rendering for CLI / CI output."""
    return "\n".join(
        str(v) for v in sorted(violations,
                               key=lambda v: (v.path, v.line, v.rule)))
