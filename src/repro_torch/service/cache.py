"""Stderr-aware result cache with counter-stream top-up (port of
``repro.service.cache``; numpy on the host, tensors never reach it).

A cache entry stores the *raw accumulators* ``(s1, s2, n)`` of a
canonical family, not the finished estimate.  That choice buys two
things:

* **hit** — when the cached sample count already yields a standard error
  at or below the requested precision, the result is finalized straight
  from the accumulators: zero new kernel launches;
* **top-up** — when it does not, the engine *resumes* the counter-based
  sample stream at ``sample_offset = n`` instead of recomputing from
  scratch: the cached work is never wasted, and the merged accumulators
  are bit-identical to an uninterrupted run of the same total budget
  (asserted by ``tests/core/test_resume.py``).

Bit-identity needs a fixed association order for the f32 merges, so all
accumulation is quantized into fixed-size **rounds** of
``round_samples`` each, deposited strictly in order and left-folded one
round at a time — the same fold an uninterrupted service evaluation
performs.  A replayed round (same index deposited twice — restarted
waves, racing wave drivers) is skipped, which is exact: the counters
make any recomputation of a round bit-identical to the folded one.
``rounds_needed`` converts a stderr target into additional rounds using
the cached variance estimate (stderr shrinks as 1/sqrt(n)).

Entries also own the family's **counter-space offset**: the service
allocates each distinct integral a disjoint global function-id range (a
bump allocator over the 2^24-id space of ``rng.DIM_STRIDE``), so every
Threefry counter of every cached stream stays addressable and collision
free no matter which batch the family first arrived in.

Concurrency: an entry's mutable accumulator state lives in ONE tuple,
swapped atomically under the cache lock by :meth:`deposit`; readers
(``stderr``/``finalize``/``meets``) work from a single snapshot, so a
submit racing a worker deposit sees either the old or the new round —
never half of one.

Durability: with a :class:`~repro_torch.service.store.DurableStore` attached,
every allocation and deposit is journaled *before* the in-memory fold
(write-ahead), and persisted streams from a previous process live in a
**dormant** table until a request re-asks for them — rehydration
restores the exact ``(s1, s2, n, rounds_done)`` accumulators and the
original counter-space ``fn_offset``, so a warm restart serves satisfied
requests with zero launches and tops up partial ones bit-identically.
Dormant streams survive compaction: :meth:`snapshot_to_store` persists
them alongside the live entries.
"""

from __future__ import annotations

import math
import threading

import numpy as np

from repro_torch.analysis import streams as _analysis
from repro_torch.core import direct_mc
from repro_torch.core.direct_mc import SumsState
from repro_torch.core.integrand import IntegrandFamily
from repro_torch.service.store import DurableStore, EntryState, GridRecord

# id space addressable by the counter layout: fn_id * DIM_STRIDE + dim
# must fit u32, so fn_id < 2**24 (DIM_STRIDE = 256)
_ID_SPACE = 1 << 24


class CacheEntry:
    """Accumulated sample stream of one canonical family."""

    def __init__(self, chash: str, family: IntegrandFamily, fn_offset: int):
        self.chash = chash
        self.family = family         # canonical (compactified) representative
        self.fn_offset = fn_offset   # allocated global function-id range start
        self.hits = 0
        n_fn = family.n_fn
        # box volume cached as numpy so the precision checks the engine
        # runs under its lock every wave stay off the device
        from repro_torch.core.domains import box_volume
        self._vol = box_volume(family.domains).cpu().numpy().astype(np.float32)
        # (s1, s2, n, rounds_done): replaced wholesale, never mutated
        self._state = (np.zeros(n_fn, np.float32),
                       np.zeros(n_fn, np.float32), 0, 0)
        # poison ladder (non-finite deposits, see deposit_wave): strikes
        # count consecutive poisoned waves; `degraded` routes the stream
        # off the fused path, `quarantined` stops scheduling it at all
        self.poison_strikes = 0
        self.degraded = False
        self.quarantined = False

    @property
    def n_fn(self) -> int:
        return self.family.n_fn

    def snapshot(self) -> tuple[np.ndarray, np.ndarray, int, int]:
        """One consistent (s1, s2, n, rounds_done) view."""
        return self._state

    @property
    def s1(self) -> np.ndarray:
        return self._state[0]

    @property
    def s2(self) -> np.ndarray:
        return self._state[1]

    @property
    def n(self) -> int:
        return self._state[2]

    @property
    def rounds_done(self) -> int:
        return self._state[3]

    def sums(self) -> SumsState:
        s1, s2, n, _ = self.snapshot()
        return SumsState(s1=s1, s2=s2, n=np.float32(n))

    def finalize(self) -> direct_mc.MCResult:
        """Mean and stderr as numpy f32, the arithmetic of
        ``direct_mc.finalize`` on the host."""
        s1, s2, n, _ = self.snapshot()
        nf = np.float32(max(n, 1))
        mean_f = s1 / nf
        var_f = np.maximum(s2 / nf - np.square(mean_f), np.float32(0.0))
        return direct_mc.MCResult(mean=self._vol * mean_f,
                                  stderr=self._vol * np.sqrt(var_f / nf),
                                  n=np.float32(n))

    def stderr(self) -> np.ndarray:
        """Current per-function standard error (inf before any round)."""
        return self._stderr_of(self.snapshot())

    def _stderr_of(self, state) -> np.ndarray:
        # numpy mirror of direct_mc.finalize's stderr (hot path: called
        # per pending request per wave, often under the engine lock)
        s1, s2, n, _ = state
        if n == 0:
            return np.full(self.n_fn, np.inf, np.float32)
        nf = np.float32(n)
        mean_f = s1 / nf
        var_f = np.maximum(s2 / nf - np.square(mean_f), np.float32(0.0))
        return self._vol * np.sqrt(var_f / nf)


class ResultCache:
    """In-memory cache of canonical-family accumulators (thread-safe)."""

    def __init__(self, round_samples: int = 65536,
                 store: DurableStore | None = None, obs=None,
                 degrade_after: int = 2, quarantine_after: int = 3):
        if round_samples <= 0:
            raise ValueError("round_samples must be positive")
        if not 1 <= degrade_after <= quarantine_after:
            raise ValueError("need 1 <= degrade_after <= quarantine_after")
        if obs is None:
            from repro_torch.obs import Observability
            obs = Observability.disabled()
        self.obs = obs
        self.round_samples = int(round_samples)
        # poison-ladder thresholds, in consecutive poisoned waves: at
        # `degrade_after` strikes a stream leaves the fused path (a
        # fused-kernel bug must not condemn the integrand), at
        # `quarantine_after` it stops being scheduled at all
        self.degrade_after = int(degrade_after)
        self.quarantine_after = int(quarantine_after)
        self._entries: dict[str, CacheEntry] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self.store = store
        self._dormant: dict[str, EntryState] = {}
        # adapted streams' importance grids, keyed by the child chash: the
        # epoch chains a resumed planner adopts (compaction keeps them)
        self._grids: dict[str, GridRecord] = {}
        self.recovered = None
        if store is not None:
            state = store.load()
            if (state.round_samples is not None
                    and state.round_samples != self.round_samples):
                raise ValueError(
                    f"state dir holds streams quantized into rounds of "
                    f"{state.round_samples} samples; this cache is "
                    f"configured with round_samples={self.round_samples}")
            self._dormant = dict(state.entries)
            self._next_id = max(self._next_id, state.next_id)
            self._grids = dict(state.grids)
            self.recovered = state

    # -- lookup / allocation --------------------------------------------------
    def get(self, chash: str,
            family: IntegrandFamily | None = None) -> CacheEntry | None:
        """Entry for ``chash`` if it exists — in memory, or (when the
        canonical ``family`` is supplied) rehydrated from persisted
        state.  Never allocates a new counter range."""
        entry = self._entries.get(chash)
        if entry is not None or family is None:
            return entry
        if not self._dormant:     # only ever shrinks: cold misses stay
            return None           # lock-free (every store-less engine)
        with self._lock:
            return self._rehydrate_locked(chash, family)

    def _rehydrate_locked(self, chash: str,
                          family: IntegrandFamily) -> CacheEntry | None:
        entry = self._entries.get(chash)
        if entry is not None:
            return entry
        st = self._dormant.pop(chash, None)
        if st is None:
            return None
        if st.n_fn != family.n_fn:
            raise ValueError(
                f"persisted stream {chash[:16]} has n_fn={st.n_fn} but the "
                f"submitted family has n_fn={family.n_fn}")
        if st.round_samples != self.round_samples:
            raise ValueError(
                f"persisted stream {chash[:16]} was quantized into rounds "
                f"of {st.round_samples}; cache uses {self.round_samples}")
        entry = CacheEntry(chash=chash, family=family,
                           fn_offset=st.fn_offset)
        entry._state = (np.asarray(st.s1, np.float32),
                        np.asarray(st.s2, np.float32),
                        int(st.n), int(st.rounds_done))
        self._entries[chash] = entry
        return entry

    def get_or_allocate(self, chash: str, family: IntegrandFamily) -> CacheEntry:
        """Existing entry for ``chash`` (rehydrating persisted state if
        needed), or a fresh one with its own counter-space range.
        ``family`` must already be canonical."""
        with self._lock:
            entry = self._rehydrate_locked(chash, family)
            if entry is not None:
                entry.hits += 1
                return entry
            n_fn = family.n_fn
            if self._next_id + n_fn > _ID_SPACE:
                raise RuntimeError(
                    f"counter id space exhausted ({_ID_SPACE} function ids)")
            if _analysis.asserts_enabled():
                # STR001 live: live + dormant streams all own disjoint
                # counter ranges the new allocation must clear
                _analysis.assert_disjoint_allocation(
                    [(c, e.fn_offset, e.n_fn)
                     for c, e in self._entries.items()]
                    + [(c, st.fn_offset, st.n_fn)
                       for c, st in self._dormant.items()],
                    chash, self._next_id, n_fn)
            entry = CacheEntry(chash=chash, family=family,
                               fn_offset=self._next_id)
            self._next_id += n_fn
            self._entries[chash] = entry
        if self.store is not None:
            # journaled outside the cache lock (disk I/O must not stall
            # readers; lock order is always store.mutex -> cache lock).
            # Should a crash land in this gap, any deposit journaled for
            # the missing alloc is dropped on replay and recomputed —
            # counter addressing makes that recomputation bit-identical.
            self.store.append_alloc(chash, fn_offset=entry.fn_offset,
                                    n_fn=n_fn,
                                    round_samples=self.round_samples)
        return entry

    # -- importance-grid epoch chains -----------------------------------------
    def register_grid(self, chash: str, *, parent: str, epoch: int,
                      edges) -> GridRecord:
        """Record an adapted stream's importance grid, journal first.

        A refit opens a NEW epoch stream (``chash``) keyed by its edges
        rather than mutating history, so accumulators stay bit-identically
        resumable.  Call it *before* ``get_or_allocate(chash, ...)``: the
        WAL must carry the grid ahead of the child's alloc (the STR007
        ordering rule).  Idempotent: a re-registration returns the
        existing record unjournaled.
        """
        edges = np.ascontiguousarray(edges, np.float32)
        with self._lock:
            rec = self._grids.get(chash)
            if rec is not None:
                return rec
            rec = GridRecord(
                chash=chash, parent=parent, epoch=int(epoch),
                n_fn=int(edges.shape[0]), dim=int(edges.shape[1]),
                n_bins=int(edges.shape[2]) - 1, edges=edges)
            self._grids[chash] = rec
        if self.store is not None:
            # journaled outside the cache lock, as get_or_allocate does: a
            # grid record with no child alloc is benign on replay
            self.store.append_grid(chash, parent=parent, epoch=int(epoch),
                                   edges=edges)
        return rec

    def grid_for(self, chash: str) -> GridRecord | None:
        """The importance-grid record of an adapted stream (or None)."""
        with self._lock:
            return self._grids.get(chash)

    def grid_chain(self, chash: str) -> list[GridRecord]:
        """Grid records from epoch 1 up to ``chash``'s epoch, in order
        (empty for an unadapted stream)."""
        chain: list[GridRecord] = []
        with self._lock:
            rec = self._grids.get(chash)
            while rec is not None:
                chain.append(rec)
                rec = self._grids.get(rec.parent)
        chain.reverse()
        return chain

    def grid_tip(self, base_chash: str) -> GridRecord | None:
        """Deepest journaled epoch of the chain rooted at ``base_chash``
        (None when the base stream was never adapted).  A resumed planner
        adopts the tip (its chash and edges) rather than refitting.
        Should a parent have several children, the lexicographically
        smallest chash wins, so resume stays stable."""
        with self._lock:
            children: dict[str, list[GridRecord]] = {}
            for rec in self._grids.values():
                children.setdefault(rec.parent, []).append(rec)
        tip = None
        cur = base_chash
        while cur in children:
            rec = min(children[cur], key=lambda r: r.chash)
            tip = rec
            cur = rec.chash
        return tip

    # -- precision logic ------------------------------------------------------
    def rounds_for_budget(self, n_samples: int) -> int:
        """Rounds needed to cover an ``n_samples`` budget (quantized up)."""
        return max(1, math.ceil(int(n_samples) / self.round_samples))

    def meets(self, entry: CacheEntry, *, target_stderr: float | None,
              n_samples: int | None) -> bool:
        """Does the cached stream already satisfy the request?"""
        state = entry.snapshot()
        if state[2] == 0:
            return False
        if n_samples is not None and state[3] < self.rounds_for_budget(n_samples):
            return False
        if target_stderr is not None and not np.all(
                entry._stderr_of(state) <= target_stderr):
            return False
        return True

    def rounds_needed(self, entry: CacheEntry, *, target_stderr: float | None,
                      n_samples: int | None, max_rounds: int = 1 << 16) -> int:
        """Additional rounds to schedule for this entry (0 = cache hit).

        Budget requests are exact; stderr targets are predicted from the
        cached variance (stderr ~ 1/sqrt(n)), with one bootstrap round
        when no variance estimate exists yet.  The engine re-checks after
        every wave, so an under-prediction just schedules another wave.
        """
        state = entry.snapshot()
        _, _, n, rounds_done = state
        need = 0
        if n_samples is not None:
            need = max(need, self.rounds_for_budget(n_samples) - rounds_done)
        if target_stderr is not None:
            if n == 0:
                need = max(need, 1)
            else:
                err = entry._stderr_of(state)
                if np.any(err > target_stderr):
                    # n_target / n_now = (err_now / target)^2, per function
                    ratio = float(np.max(err / max(target_stderr, 1e-30))) ** 2
                    total = math.ceil(ratio * n / self.round_samples)
                    need = max(need, total - rounds_done)
        return int(min(max(need, 0), max_rounds))

    # -- deposits -------------------------------------------------------------
    def deposit(self, entry: CacheEntry, round_index: int,
                sums: SumsState) -> bool:
        """Fold one round of sums into the entry, strictly in order.

        Returns True when the round was folded, False when it was
        already present (a replayed wave or a racing wave driver
        recomputed it — bit-identical by counter addressing, so skipping
        is exact).  A round *beyond* the fold frontier is a planner bug
        and raises: folding it would skip samples.
        """
        return self.deposit_wave([(entry, round_index, sums)],
                                 on_ahead="raise") == 1

    def deposit_wave(self, deposits, *, on_ahead: str = "skip") -> int:
        """Group-commit a whole wave of round deposits: ONE journal fsync.

        ``deposits`` is a sequence of ``(entry, round_index, sums)`` with
        each entry's rounds in ascending order (the batcher emits them
        that way).  Rounds already folded are skipped unjournaled (exact:
        counter addressing makes any recomputation bit-identical).  The
        accepted records are journaled in one batch write + fsync
        (:meth:`DurableStore.append_deposits`) *before* any of them
        folds, preserving WAL ordering: a crash can lose a suffix of the
        wave, never a folded round.  Returns the number of rounds folded.

        Rounds *beyond* an entry's fold frontier are, by default, also
        skipped (unfolded, unjournaled): a wave racing another driver can
        legitimately carry rounds whose predecessors are still in the
        other driver's in-flight wave — folding them would skip samples,
        so they are dropped and the planner re-schedules them once the
        frontier catches up.  ``on_ahead="raise"`` turns that into an
        error (the single-round :meth:`deposit` contract, where an
        ahead-of-frontier round can only be a planner bug).

        Durable path locking: the store mutex is held across journal +
        fold so the write-ahead batch and the in-memory folds are one
        atomic unit w.r.t. concurrent deposits and snapshot compaction —
        while the fsync runs OUTSIDE the cache lock, leaving readers
        (submit peeks, meets, stats) unblocked.  Lock order everywhere:
        store.mutex -> cache lock, never the reverse.
        """
        recs = [(entry, int(round_index),
                 np.asarray(sums.s1, np.float32),
                 np.asarray(sums.s2, np.float32),
                 int(np.asarray(sums.n)))
                for entry, round_index, sums in deposits]
        # per-round finite check BEFORE journaling: a NaN/Inf deposit is
        # never written ahead (it would poison every future replay) and
        # never folded — the stream takes a poison strike instead, and
        # its un-deposited rounds go back to the planner.  Checking per
        # round means one bad integrand quarantines only its own stream,
        # not the fused bucket it rode in.
        poisoned: list = []
        seen_poison: set[int] = set()
        if recs:
            clean = []
            for rec in recs:
                if np.isfinite(rec[2]).all() and np.isfinite(rec[3]).all():
                    clean.append(rec)
                elif id(rec[0]) not in seen_poison:
                    seen_poison.add(id(rec[0]))
                    poisoned.append(rec[0])
            recs = clean
        if self.store is None:
            with self._lock:
                accepted = self._admit_locked(recs, on_ahead)
                folded, states = self._fold_batch_locked(accepted)
        else:
            with self.store.mutex:
                with self._lock:
                    accepted = self._admit_locked(recs, on_ahead)
                self.store.append_deposits(
                    self.store.deposit_record(entry.chash, ri, s1, s2, n)
                    for entry, ri, s1, s2, n in accepted)
                with self._lock:
                    folded, states = self._fold_batch_locked(accepted)
        if poisoned:
            self._note_poison(poisoned)
        if folded:
            # a clean folded wave resets the strike count of streams it
            # covered (transient device/transfer glitches must not creep
            # a healthy stream toward quarantine); degradation and
            # quarantine themselves stay sticky
            with self._lock:
                for entry, *_ in accepted:
                    if id(entry) not in seen_poison and entry.poison_strikes:
                        entry.poison_strikes = 0
        self._observe_deposits(folded, states)
        return folded

    def _note_poison(self, entries) -> None:
        """Advance the poison ladder for streams whose wave deposited
        non-finite sums: reschedule (strike 1+) -> degrade off the fused
        path (``degrade_after``) -> quarantine (``quarantine_after``)."""
        degraded, quarantined = [], []
        with self._lock:
            for entry in entries:
                entry.poison_strikes += 1
                if (entry.poison_strikes >= self.degrade_after
                        and not entry.degraded):
                    entry.degraded = True
                    degraded.append(entry)
                if (entry.poison_strikes >= self.quarantine_after
                        and not entry.quarantined):
                    entry.quarantined = True
                    quarantined.append(entry)
        for entry in entries:
            self.obs.event("poison_deposit", stream=entry.chash[:16],
                           strikes=entry.poison_strikes,
                           degraded=entry.degraded,
                           quarantined=entry.quarantined)
        for entry in degraded:
            self.obs.event("degrade", stream=entry.chash[:16],
                           strikes=entry.poison_strikes)
        for entry in quarantined:
            self.obs.m["quarantined_streams"].inc()
            self.obs.event("quarantine", stream=entry.chash[:16],
                           strikes=entry.poison_strikes)

    def quarantined_streams(self) -> list[str]:
        """chashes of quarantined streams (stable order, observables
        for the metrics-agreement gate)."""
        with self._lock:
            return sorted(c for c, e in self._entries.items()
                          if e.quarantined)

    def _admit_locked(self, recs, on_ahead: str):
        """Filter a deposit batch against a local frontier image.

        The frontier advances per accepted record, so consecutive rounds
        of one entry in the same wave chain correctly.  Caller must hold
        the cache lock; in the durable path the store mutex additionally
        keeps the admitted set valid until the folds land (no other
        depositor can move a frontier in between).
        """
        frontier = {id(e): e._state[3] for e, *_ in recs}
        accepted = []
        for entry, ri, s1, s2, n in recs:
            done = frontier[id(entry)]
            if ri < done:
                continue               # replayed round: exact, unjournaled
            if ri > done:
                if on_ahead == "raise":
                    raise ValueError(
                        f"deposit gap: round {ri} into entry at "
                        f"round {done}")
                continue               # predecessors still in flight
            accepted.append((entry, ri, s1, s2, n))
            frontier[id(entry)] = done + 1
        return accepted

    def _fold_batch_locked(self, accepted):
        """Fold an admitted batch; returns (rounds folded, post-fold
        (entry, state) snapshots for telemetry).  Caller holds the cache
        lock (and, on the durable path, the store mutex)."""
        folded = 0
        states = []
        for entry, ri, s1, s2, n in accepted:
            if self._fold_locked(entry, ri, s1, s2, n):
                folded += 1
                states.append((entry, entry._state))
        return folded, states

    def _observe_deposits(self, folded: int, states) -> None:
        """Telemetry for a committed wave, outside every lock: the
        deposit-round counter and (when enabled) one convergence
        trajectory point per folded round (:mod:`repro_torch.obs.convergence`).
        States are immutable snapshots, so reading them lock-free is
        exact."""
        obs = self.obs
        if folded:
            obs.m["deposit_rounds"].inc(folded)
        if obs.record_convergence:
            for entry, state in states:
                err = entry._stderr_of(state)
                obs.convergence.record(
                    entry.chash, rounds_done=state[3], n=state[2],
                    stderr_max=float(err.max()),
                    stderr_mean=float(err.mean()))

    def _fold_locked(self, entry: CacheEntry, round_index: int,
                     s1_delta, s2_delta, n_delta: int) -> bool:
        s1, s2, n, done = entry._state
        if round_index < done:
            return False
        if round_index > done:
            raise ValueError(
                f"deposit gap: round {round_index} into entry at "
                f"round {done}")
        entry._state = (
            np.asarray(s1 + s1_delta),
            np.asarray(s2 + s2_delta),
            n + n_delta,
            done + 1,
        )
        return True

    # -- persistence ----------------------------------------------------------
    def snapshot_to_store(self) -> None:
        """Compact journal + accumulators into one atomic npz snapshot.

        Includes dormant persisted streams no request has re-asked for
        yet — compaction must never forget a stream.
        """
        if self.store is None:
            raise RuntimeError("cache has no DurableStore attached")
        # mutex first (same order as deposit): no deposit can journal or
        # fold between state collection and the journal reset, so the
        # snapshot + fresh journal always cover every folded round.  The
        # npz write itself runs outside the cache lock — readers proceed.
        with self.store.mutex:
            with self._lock:
                states = []
                for chash, entry in self._entries.items():
                    s1, s2, n, done = entry.snapshot()
                    states.append(EntryState(
                        chash=chash, fn_offset=entry.fn_offset,
                        n_fn=entry.n_fn, round_samples=self.round_samples,
                        s1=np.asarray(s1, np.float32),
                        s2=np.asarray(s2, np.float32),
                        n=int(n), rounds_done=int(done)))
                states.extend(self._dormant.values())
                grids = [self._grids[c] for c in sorted(self._grids)]
                next_id = self._next_id
            self.store.snapshot(states, next_id=next_id,
                                round_samples=self.round_samples,
                                grids=grids)

    # -- stats ----------------------------------------------------------------
    @property
    def n_entries(self) -> int:
        return len(self._entries)

    @property
    def total_samples(self) -> int:
        return sum(e.n for e in self._entries.values())

    def stats(self) -> dict:
        return {
            "entries": self.n_entries,
            "dormant": len(self._dormant),
            "function_ids_allocated": self._next_id,
            "total_samples": self.total_samples,
            "hits": sum(e.hits for e in self._entries.values()),
        }
