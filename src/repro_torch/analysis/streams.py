"""Debug-mode assertions over the service's counter-stream bookkeeping
(port of the live half of ``repro.analysis.streams``).

The cache's bit-identity promise rests on structural invariants of the
counter streams: every stream owns a pairwise-disjoint counter range
(STR001), and per-stream rounds are deposited gap-free and in order
(STR002).  The service calls these predicates at its mutation points
(``ResultCache.get_or_allocate``, ``RoundBatcher.deposit``,
``IntegrationEngine._retire_items``) when ``REPRO_ANALYSIS_ASSERTS=1``
or :func:`enable_asserts` turns them on; off by default, so the hot path
pays one ``if``.  The offline auditor stays in the reference package
(``repro.analysis.streams.audit_state_dir``); it reads state dirs the
port writes, because the format is the same byte for byte.
"""

from __future__ import annotations

import os

# -- debug-mode assertion switch ----------------------------------------------

_ASSERTS: bool | None = None


def asserts_enabled() -> bool:
    """Debug assertions on?  Env ``REPRO_ANALYSIS_ASSERTS`` (1/true/on)
    unless overridden by :func:`enable_asserts`."""
    if _ASSERTS is not None:
        return _ASSERTS
    return os.environ.get("REPRO_ANALYSIS_ASSERTS", "").lower() in (
        "1", "true", "on", "yes")


def enable_asserts(flag: bool | None) -> None:
    """Force debug assertions on/off (``None`` restores env control)."""
    global _ASSERTS
    _ASSERTS = flag


# -- shared predicates (auditor + live hooks) ---------------------------------

def find_overlaps(ranges):
    """Overlapping pairs among ``(label, start, n)`` counter ranges.

    Sort-and-sweep: only adjacent-in-start ranges can newly overlap, so
    this is O(n log n) — cheap enough for the live allocation hook.
    Empty ranges (n == 0) cannot overlap anything.
    """
    ordered = sorted(((start, start + n, label)
                      for label, start, n in ranges if n > 0))
    overlaps = []
    prev_end, prev_label = None, None
    for start, end, label in ordered:
        if prev_end is not None and start < prev_end:
            overlaps.append((prev_label, label))
        if prev_end is None or end > prev_end:
            prev_end, prev_label = end, label
    return overlaps


# -- live debug hooks ---------------------------------------------------------

def assert_disjoint_allocation(existing_ranges, label: str, start: int,
                               n: int) -> None:
    """STR001 as a live check: a fresh allocation must not overlap any
    existing stream's counter range.  ``existing_ranges`` iterates
    ``(label, start, n)`` of already-placed streams."""
    end = start + n
    for other_label, other_start, other_n in existing_ranges:
        if start < other_start + other_n and other_start < end:
            raise AssertionError(
                f"[STR001] counter range [{start}, {end}) allocated to "
                f"{label} overlaps [{other_start}, {other_start + other_n}) "
                f"owned by {other_label}")


def assert_wave_consistent(rounds_by_label: dict) -> None:
    """STR002 as a live check on one dispatched wave: each stream's
    rounds must be strictly consecutive ascending — a duplicate round
    is a double-deposit in the making, a gap would wedge the fold
    frontier.  (Cross-wave ordering is enforced by the cache's
    admission rules; this guards the batcher's own emission contract.)
    """
    for label, rounds in rounds_by_label.items():
        if list(rounds) != list(range(rounds[0], rounds[0] + len(rounds))):
            raise AssertionError(
                f"[STR002] wave deposits rounds {list(rounds)} for "
                f"{label}: per-stream rounds must be consecutive "
                "ascending (duplicates double-deposit, gaps wedge the "
                "fold frontier)")


def assert_inflight_consistent(label: str, count: int) -> None:
    """In-flight accounting must never go negative — a negative count
    means a wave was retired twice (the double-deposit precursor)."""
    if count < 0:
        raise AssertionError(
            f"[STR002] in-flight round count for {label} went negative "
            f"({count}): a wave was retired twice")
