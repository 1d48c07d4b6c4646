"""Layer 3: determinism analyzer over durable stream state (port of
``repro.analysis.streams``).

The cache's bit-identity promise (a top-up equals an uninterrupted run)
rests on structural invariants of the counter-stream bookkeeping:

* every stream owns a **pairwise-disjoint** counter-space range
  ``[fn_offset, fn_offset + n_fn)`` — overlap means two streams draw the
  same Threefry counters (STR001, STR004 for the allocator high-water
  mark that guards future allocations);
* per-stream deposit rounds are **gap-free and monotone** — the f32
  accumulators are left-folded strictly in round order, so a skipped or
  reordered round changes association order and breaks bit-identity
  (STR002), and every round's delta must match the stream's shape and
  round quantum (STR003, STR005);
* every deposit references an **allocated** stream (STR006);
* adapted streams' **grid epochs chain contiguously**, each grid
  journaled before its child stream's alloc (STR007).

This module proves them two ways from ONE set of predicates:

* :func:`audit_state_dir` — an offline auditor over a ``DurableStore``
  state dir (``python -m repro_torch.analysis --state-dir ...``,
  ``serve_integrals --audit-state``).  The on-disk format is the
  reference's, so on one directory this auditor and
  ``repro.analysis.streams.audit_state_dir`` report the same
  violations, in the same order;
* cheap **debug-mode assertion hooks** the live service calls at its
  mutation points (``ResultCache.get_or_allocate``,
  ``RoundBatcher.deposit``, ``IntegrationEngine._retire_items``),
  enabled via ``REPRO_ANALYSIS_ASSERTS=1`` or :func:`enable_asserts` —
  off by default so the hot path pays one predicate call's ``if``.

No torch at import: the auditor reads the state dir through the port's
``service/store.py``, imported only when it runs.
"""

from __future__ import annotations

import dataclasses
import os

from repro_torch.analysis.violations import Violation

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


def classify_round(frontier: int, round_index: int) -> str:
    """'fold' (the next in-order round), 'replay' (already folded — an
    exact recomputation, skippable), or 'gap' (beyond the frontier —
    folding it would skip samples)."""
    if round_index < frontier:
        return "replay"
    if round_index == frontier:
        return "fold"
    return "gap"


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


# -- offline auditor ----------------------------------------------------------

@dataclasses.dataclass
class AuditReport:
    """What :func:`audit_state_dir` proved (or disproved)."""

    state_dir: str
    violations: list[Violation]
    streams: int = 0
    journal_records: int = 0
    deposits_folded: int = 0
    deposits_replayed: int = 0
    truncated_tail_bytes: int = 0   # expected after SIGKILL: informational

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        status = "clean" if self.ok else f"{len(self.violations)} violation(s)"
        return (f"audit {self.state_dir}: {status} — {self.streams} "
                f"stream(s), {self.journal_records} journal record(s), "
                f"{self.deposits_folded} folded / "
                f"{self.deposits_replayed} replayed deposit(s), "
                f"{self.truncated_tail_bytes} torn tail byte(s)")


@dataclasses.dataclass
class _Stream:
    fn_offset: int
    n_fn: int
    round_samples: int
    frontier: int


def audit_state_dir(state_dir: str) -> AuditReport:
    """Prove the STR invariants over one DurableStore state dir.

    Reads meta.json, snapshot.npz and journal.bin read-only (never
    truncates — auditing must not mutate evidence) and replays the
    journal against the same admission rules the store applies, flagging
    every record that breaks a determinism invariant.  A torn journal
    tail is *reported* but is not a violation: that is exactly the
    artifact a SIGKILL is allowed to leave.
    """
    import json

    # lazy: the service package imports torch
    from repro_torch.service.store import (DurableStore, _decode_f32,
                                           read_journal, read_snapshot)

    report = AuditReport(state_dir=str(state_dir), violations=[])
    found = report.violations
    meta_path = os.path.join(state_dir, DurableStore.META)
    snap_path = os.path.join(state_dir, DurableStore.SNAPSHOT)
    journal_path = os.path.join(state_dir, DurableStore.JOURNAL)

    quantum = None          # round_samples consensus across sources
    quantum_src = None
    if os.path.exists(meta_path):
        with open(meta_path, encoding="utf-8") as f:
            meta = json.load(f)
        if "round_samples" in meta:
            quantum = int(meta["round_samples"])
            quantum_src = "meta.json"

    streams: dict[str, _Stream] = {}
    # child chash -> (parent chash, epoch, source path, line) of every
    # grid record seen; chain contiguity is proven at the end so the
    # verdict is independent of snapshot/journal interleaving
    grids: dict[str, tuple[str, int, str, int]] = {}
    journal_allocs: set[str] = set()
    hwm = 0
    if os.path.exists(snap_path):
        snap_meta, _ = read_snapshot(snap_path)
        hwm = int(snap_meta["next_id"])
        snap_quantum = int(snap_meta["round_samples"])
        if quantum is not None and snap_quantum != quantum:
            found.append(Violation(
                rule="STR005", path=snap_path, line=0,
                message=f"snapshot round_samples={snap_quantum} disagrees "
                        f"with {quantum_src} round_samples={quantum}"))
        quantum = quantum if quantum is not None else snap_quantum
        quantum_src = quantum_src or "snapshot"
        for i, ent in enumerate(snap_meta["entries"]):
            chash = ent["chash"]
            st = _Stream(fn_offset=int(ent["fn_offset"]),
                         n_fn=int(ent["n_fn"]),
                         round_samples=int(ent["round_samples"]),
                         frontier=int(ent["rounds_done"]))
            streams[chash] = st
            if st.round_samples != quantum:
                found.append(Violation(
                    rule="STR005", path=snap_path, line=i + 1,
                    message=f"stream {chash[:16]} quantized into rounds of "
                            f"{st.round_samples}; state dir uses {quantum}"))
            if st.fn_offset + st.n_fn > hwm:
                found.append(Violation(
                    rule="STR004", path=snap_path, line=i + 1,
                    message=f"stream {chash[:16]} range "
                            f"[{st.fn_offset}, {st.fn_offset + st.n_fn}) "
                            f"exceeds the allocator high-water mark {hwm}: "
                            "a future allocation could collide"))
        for a, b in find_overlaps(
                (c, s.fn_offset, s.n_fn) for c, s in streams.items()):
            found.append(Violation(
                rule="STR001", path=snap_path, line=0,
                message=f"streams {a[:16]} and {b[:16]} own overlapping "
                        "counter ranges"))
        for i, g in enumerate(snap_meta.get("grids", []), start=1):
            grids[g["chash"]] = (g["parent"], int(g["epoch"]),
                                 snap_path, i)

    records, bad_tail = read_journal(journal_path)
    report.truncated_tail_bytes = bad_tail
    report.journal_records = len(records)
    for lineno, record in enumerate(records, start=1):
        kind = record.get("t")
        if kind == "alloc":
            chash = record["chash"]
            journal_allocs.add(chash)
            fn_offset = int(record["fn_offset"])
            n_fn = int(record["n_fn"])
            rs = int(record["round_samples"])
            if quantum is None:
                quantum, quantum_src = rs, "journal"
            elif rs != quantum:
                found.append(Violation(
                    rule="STR005", path=journal_path, line=lineno,
                    message=f"alloc of {chash[:16]} carries "
                            f"round_samples={rs}; {quantum_src} says "
                            f"{quantum}"))
            known = streams.get(chash)
            if known is not None:
                if (known.fn_offset, known.n_fn) != (fn_offset, n_fn):
                    found.append(Violation(
                        rule="STR001", path=journal_path, line=lineno,
                        message=f"stream {chash[:16]} re-allocated at "
                                f"[{fn_offset}, {fn_offset + n_fn}); it "
                                f"already owns [{known.fn_offset}, "
                                f"{known.fn_offset + known.n_fn})"))
                continue
            overlap = [c for c, s in streams.items()
                       if fn_offset < s.fn_offset + s.n_fn
                       and s.fn_offset < fn_offset + n_fn]
            if overlap:
                found.append(Violation(
                    rule="STR001", path=journal_path, line=lineno,
                    message=f"alloc of {chash[:16]} at [{fn_offset}, "
                            f"{fn_offset + n_fn}) overlaps stream(s) "
                            f"{', '.join(c[:16] for c in overlap)}"))
            elif fn_offset < hwm:
                found.append(Violation(
                    rule="STR004", path=journal_path, line=lineno,
                    message=f"alloc of {chash[:16]} at {fn_offset} is "
                            f"below the allocator high-water mark {hwm}: "
                            "the bump allocator never goes backwards"))
            streams[chash] = _Stream(fn_offset=fn_offset, n_fn=n_fn,
                                     round_samples=rs, frontier=0)
            hwm = max(hwm, fn_offset + n_fn)
        elif kind == "dep":
            chash = record["chash"]
            st = streams.get(chash)
            if st is None:
                found.append(Violation(
                    rule="STR006", path=journal_path, line=lineno,
                    message=f"deposit for {chash[:16]} has no allocation "
                            "anywhere in snapshot or journal: it is "
                            "dropped on replay and silently recomputed"))
                continue
            round_index = int(record["round"])
            s1 = _decode_f32(record["s1"])
            s2 = _decode_f32(record["s2"])
            if s1.shape != (st.n_fn,) or s2.shape != (st.n_fn,):
                found.append(Violation(
                    rule="STR003", path=journal_path, line=lineno,
                    message=f"deposit for {chash[:16]} carries "
                            f"{s1.shape[0]}/{s2.shape[0]} function sums; "
                            f"the stream has n_fn={st.n_fn}"))
                continue
            if quantum is not None and int(record["n"]) != quantum:
                found.append(Violation(
                    rule="STR003", path=journal_path, line=lineno,
                    message=f"deposit for {chash[:16]} folds "
                            f"{record['n']} samples; the round quantum "
                            f"is {quantum}"))
            verdict = classify_round(st.frontier, round_index)
            if verdict == "gap":
                found.append(Violation(
                    rule="STR002", path=journal_path, line=lineno,
                    message=f"deposit round {round_index} for "
                            f"{chash[:16]} is beyond the fold frontier "
                            f"{st.frontier}: rounds "
                            f"[{st.frontier}, {round_index}) are missing"))
            elif verdict == "replay":
                report.deposits_replayed += 1
            else:
                st.frontier += 1
                report.deposits_folded += 1
        elif kind == "grid":
            chash = record["chash"]
            parent = record["parent"]
            epoch = int(record["epoch"])
            if chash in journal_allocs:
                found.append(Violation(
                    rule="STR007", path=journal_path, line=lineno,
                    message=f"grid record for {chash[:16]} arrives after "
                            "its stream's alloc: the WAL must journal an "
                            "adapted stream's grid before the stream "
                            "itself, or a crash in between strands the "
                            "child without its edges"))
            known = grids.get(chash)
            if known is not None:
                if (known[0], known[1]) != (parent, epoch):
                    found.append(Violation(
                        rule="STR007", path=journal_path, line=lineno,
                        message=f"duplicate grid record for {chash[:16]} "
                                f"disagrees: parent {parent[:16]} epoch "
                                f"{epoch} vs recorded parent "
                                f"{known[0][:16]} epoch {known[1]}"))
            else:
                grids[chash] = (parent, epoch, journal_path, lineno)
        else:
            found.append(Violation(
                rule="STR003", path=journal_path, line=lineno,
                message=f"unknown journal record type {kind!r}"))

    # STR007 chain contiguity, order-independently over every grid seen:
    # epoch k's parent must hold a grid record at epoch k-1, and epoch 1
    # must chain to a base stream (no grid record of its own)
    for chash in sorted(grids):
        parent, epoch, src, line = grids[chash]
        parent_grid = grids.get(parent)
        expect = parent_grid[1] + 1 if parent_grid is not None else 1
        if epoch != expect:
            holds = (f"holds a grid record at epoch {parent_grid[1]}"
                     if parent_grid is not None
                     else "has no grid record (a base stream)")
            found.append(Violation(
                rule="STR007", path=src, line=line,
                message=f"grid for {chash[:16]} opens epoch {epoch}, but "
                        f"its parent {parent[:16]} {holds} — the epoch "
                        f"chain must be contiguous (expected epoch "
                        f"{expect})"))

    report.streams = len(streams)
    return report
