"""Crash-safe persistence for the service result cache.

The engine's strongest invariant — a cache top-up is *bit-identical* to
an uninterrupted run (``tests/core/test_resume.py``) — is in-process
only as long as the accumulators live in memory.  This module makes it a
cross-process property: every unit of durable state the cache owns is
either journaled or snapshotted, so a SIGKILL at any instant loses at
most the round deposit being written, never a folded one.

Two files under ``state_dir``:

* ``journal.bin`` — an append-only **write-ahead journal**.  Each record
  is ``MAGIC | u32 length | u32 crc32 | payload`` with a JSON payload
  (f32 accumulator arrays base64-encoded raw little-endian, so replay
  folds the *exact bits* the live cache folded).  Three record types:
  ``alloc`` (a stream's counter-space placement: chash, fn_offset,
  n_fn, round size), ``dep`` (one round's ``(s1, s2, n)`` delta) and
  ``grid`` (an adapted stream's importance-grid fit, journaled before
  the adapted stream's ``alloc``).  Records are fsynced by
  default; a record is journaled *before* the in-memory fold it
  describes (WAL ordering).  Whole waves of deposits
  **group-commit** through :meth:`DurableStore.append_deposits` — one
  write + one fsync for the batch; a crash mid-batch tears at a record
  boundary, so the durable prefix is always a prefix of the wave's
  deposits (the per-record crash window, amortized).

* ``snapshot.npz`` — periodic **compaction** of journal + accumulators
  into one atomic npz (tmp + fsync + ``os.replace``), after which the
  journal is reset.  A crash between snapshot commit and journal reset
  is benign: replay skips deposits of rounds the snapshot already folded
  (the same skip rule the live cache applies to replayed waves).

``load()`` restores snapshot then journal, **truncating** a partial or
corrupt journal tail (torn write at the kill instant, garbage append)
instead of crashing — everything before the first bad record survives.
The bump allocator's high-water mark rides along in both formats, so a
reloaded stream resumes at the exact ``sample_offset`` and counter range
it would have had uninterrupted, and new streams never collide with
persisted ones.

``meta.json`` pins the engine configuration a state dir was created
with (seed, round size); reopening with a different configuration is an
error rather than a silently different sample stream.

**Fail-closed appends**: a journal write that errors mid-record (ENOSPC,
failed fsync, torn write) leaves bytes of unknown durability at the
tail.  ``_write`` rewinds the file to the last known-good record
boundary before re-raising, so the *next* append frames correctly and a
retried wave never lands after garbage — the cache acks a deposit only
once its journal record is durably framed.

**Single-writer lease** (``lease.json``): one engine owns a state dir at
a time.  The lease is an fsynced JSON record ``{token, pid, acquired,
expires}`` renewed (heartbeat) on journal activity; a second process
opening the dir takes over only when the lease is *expired*, its holder
process is *dead*, or the holder is this same process (an abandoned
in-process handle).  An unexpired lease with a live foreign holder
raises :class:`LeaseHeld` — the first concrete step of the ROADMAP's
replicated-engine scale-out item.  Heartbeats verify the on-disk token
still matches; a usurped writer gets :class:`LeaseLost` instead of
silently double-writing (fencing).

**On a mesh** (:class:`MeshStore`) every rank runs an engine, and the
ranks hold the same cache bit for bit, so one state dir serves them all:
rank 0 owns it (the only :class:`DurableStore`: lease, meta, journal,
snapshots) and the other ranks write nothing.  Each store operation runs
on rank 0 and then broadcasts its outcome, so a failure on rank 0
raises the same error on every rank, and recovery broadcasts the state
rank 0 read, so every rank's cache starts from the same bits.
"""

from __future__ import annotations

import base64
import dataclasses
import errno
import json
import os
import pickle
import struct
import threading
import zlib

import numpy as np

from repro_torch.obs import clock as _clock

_MAGIC = b"ZMJ1"
_HEADER = struct.Struct("<II")          # payload length, crc32(payload)
_HEADER_BYTES = len(_MAGIC) + _HEADER.size
_SNAPSHOT_VERSION = 1


class LeaseHeld(RuntimeError):
    """The state dir's lease is held by a live process elsewhere."""


class LeaseLost(RuntimeError):
    """Our lease token was usurped — stop writing (fencing)."""


def _pid_alive(pid: int) -> bool:
    """Best-effort liveness probe for a same-host lease holder."""
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True      # exists but not ours to signal (or unknowable)
    return True


def _encode_f32(arr: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(arr, dtype="<f4").tobytes()).decode("ascii")


def _decode_f32(text: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(text), dtype="<f4")


@dataclasses.dataclass
class EntryState:
    """Durable image of one cached stream's accumulators + placement."""

    chash: str
    fn_offset: int
    n_fn: int
    round_samples: int
    s1: np.ndarray            # (n_fn,) f32
    s2: np.ndarray            # (n_fn,) f32
    n: int = 0
    rounds_done: int = 0


@dataclasses.dataclass
class GridRecord:
    """Durable image of one adapted stream's importance grid.

    ``chash`` names the adapted (child) stream the grid serves;
    ``parent`` the stream the pilot was fitted against (the previous
    epoch's adapted stream, or the base canonical stream for epoch 1).
    The exact f32 edges ride along so a resumed engine rebuilds the
    adapted family bit-identically instead of refitting.
    """

    chash: str
    parent: str
    epoch: int
    n_fn: int
    dim: int
    n_bins: int
    edges: np.ndarray         # (n_fn, dim, n_bins + 1) f32


@dataclasses.dataclass
class RecoveredState:
    """What ``load()`` reconstructed from disk."""

    entries: dict[str, EntryState]
    next_id: int = 0                  # allocator high-water mark
    round_samples: int | None = None  # None when the dir is fresh
    journal_records: int = 0          # complete records replayed
    dropped_records: int = 0          # valid records that could not fold
    truncated_bytes: int = 0          # corrupt/partial tail removed
    grids: dict[str, GridRecord] = dataclasses.field(default_factory=dict)


def read_journal(path: str) -> tuple[list[dict], int]:
    """Decode every complete record of a journal file, read-only.

    Returns ``(records, bad_tail_bytes)``: the JSON payloads of all
    well-framed records in append order, plus the number of trailing
    bytes that do not form a complete valid record (torn write at a kill
    instant, bit rot).  Never writes — this is the parsing half of
    :meth:`DurableStore._replay_journal`, shared with the offline
    determinism auditor (``repro.analysis.streams``).
    """
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return [], 0
    records: list[dict] = []
    offset = 0
    while True:
        header_end = offset + _HEADER_BYTES
        if header_end > len(data):
            break                               # partial header
        if data[offset:offset + len(_MAGIC)] != _MAGIC:
            break                               # corrupt framing
        length, crc = _HEADER.unpack_from(data, offset + len(_MAGIC))
        end = header_end + length
        if end > len(data):
            break                               # torn payload
        payload = data[header_end:end]
        if zlib.crc32(payload) != crc:
            break                               # bit rot / torn write
        try:
            records.append(json.loads(payload))
        except ValueError:
            break
        offset = end
    return records, len(data) - offset


def read_snapshot(path: str) -> tuple[dict, dict]:
    """Decode a snapshot npz, read-only: ``(meta, arrays)``.

    ``meta`` is the embedded JSON dict (version, next_id, round_samples,
    entries); ``arrays`` maps ``s1_*``/``s2_*`` names to f32 arrays.
    Raises on version mismatch — shared by :meth:`DurableStore.load` and
    the offline auditor.
    """
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        if meta.get("version") != _SNAPSHOT_VERSION:
            raise ValueError(
                f"snapshot {path!r} has version {meta.get('version')!r}; "
                f"expected {_SNAPSHOT_VERSION}")
        arrays = {name: np.asarray(z[name], np.float32)
                  for name in z.files if name != "meta"}
    return meta, arrays


class DurableStore:
    """Append-only journal + atomic npz snapshots under one directory."""

    JOURNAL = "journal.bin"
    SNAPSHOT = "snapshot.npz"
    META = "meta.json"
    LEASE = "lease.json"

    def __init__(self, state_dir: str, *, fsync: bool = True, obs=None,
                 faults=None, lease_ttl: float | None = 30.0):
        if obs is None:
            from repro_torch.obs import Observability
            obs = Observability.disabled()
        if faults is None:
            from repro_torch.service.faults import NULL_FAULTS
            faults = NULL_FAULTS
        self.obs = obs
        self.faults = faults
        self.state_dir = str(state_dir)
        self.fsync = bool(fsync)
        os.makedirs(self.state_dir, exist_ok=True)
        self.journal_path = os.path.join(self.state_dir, self.JOURNAL)
        self.snapshot_path = os.path.join(self.state_dir, self.SNAPSHOT)
        self.meta_path = os.path.join(self.state_dir, self.META)
        self.lease_path = os.path.join(self.state_dir, self.LEASE)
        self._journal_f = None
        # byte offset of the last durably framed record boundary; a
        # failed append rewinds to it so the journal never grows a
        # torn middle (fail-closed, see module docstring)
        self._good_size = 0
        # serializes appends against each other and against snapshot's
        # journal reset; a caller may hold it across append + its own
        # in-memory apply to stay coherent with a concurrent snapshot
        # (reentrant so such callers can still invoke append/snapshot)
        self.mutex = threading.RLock()
        self.lease_ttl = None if lease_ttl is None else float(lease_ttl)
        self._lease_token = f"{os.getpid()}-{os.urandom(8).hex()}"
        self._lease_renewed: float | None = None
        if self.lease_ttl is not None:
            self._acquire_lease()

    # -- single-writer lease --------------------------------------------------
    def _read_lease(self) -> dict | None:
        try:
            with open(self.lease_path, encoding="utf-8") as f:
                return json.load(f)
        except (FileNotFoundError, ValueError):
            return None

    def _write_lease(self, now: float) -> None:
        record = {"token": self._lease_token, "pid": os.getpid(),
                  "acquired": now, "expires": now + self.lease_ttl}
        tmp = self.lease_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(record, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.lease_path)
        self._sync_dir()
        self._lease_renewed = now

    def _acquire_lease(self) -> None:
        """Claim the state dir, taking over a crash-expired lease.

        Takeover conditions (any one suffices): the lease expired, its
        holder process is dead (SIGKILL leaves an unexpired lease
        behind — waiting out the TTL would stall every warm restart),
        or the holder is this same process (an abandoned handle).  A
        live foreign holder raises :class:`LeaseHeld`.
        """
        now = _clock.wall()
        existing = self._read_lease()
        reason = None
        if existing is not None:
            pid = existing.get("pid")
            expires = float(existing.get("expires", 0.0))
            if pid == os.getpid():
                reason = "same_process"
            elif expires <= now:
                reason = "expired"
            elif pid is None or not _pid_alive(pid):
                reason = "holder_dead"
            else:
                raise LeaseHeld(
                    f"state dir {self.state_dir!r} is leased to pid {pid} "
                    f"for another {expires - now:.1f}s; takeover requires "
                    f"expiry or holder death")
        self._write_lease(now)
        if reason is not None:
            self.obs.event("lease_takeover", state_dir=self.state_dir,
                           reason=reason,
                           previous_pid=existing.get("pid"))

    def heartbeat(self, force: bool = False) -> None:
        """Renew the lease once half the TTL has elapsed (cheap to call
        every wave).  Raises :class:`LeaseLost` if another writer took
        the lease over — the fencing check that keeps a paused-then-
        resumed engine from double-writing a usurped dir."""
        if self.lease_ttl is None:
            return
        now = _clock.wall()
        if (not force and self._lease_renewed is not None
                and now - self._lease_renewed < self.lease_ttl / 2.0):
            return
        with self.mutex:
            existing = self._read_lease()
            if (existing is not None
                    and existing.get("token") != self._lease_token):
                raise LeaseLost(
                    f"lease on {self.state_dir!r} now belongs to "
                    f"pid {existing.get('pid')}; this writer must stop")
            self._write_lease(now)

    def _release_lease(self) -> None:
        if self.lease_ttl is None:
            return
        existing = self._read_lease()
        if existing is not None and existing.get("token") == self._lease_token:
            try:
                os.unlink(self.lease_path)
            except OSError:
                pass

    # -- configuration guard --------------------------------------------------
    def ensure_meta(self, meta: dict) -> None:
        """Pin ``meta`` on first use; verify it on every reopen.

        A state dir replays a specific counter stream: reopening it with
        a different seed or round size would top up with *different*
        samples and silently break bit-identity, so mismatches raise.
        """
        if os.path.exists(self.meta_path):
            with open(self.meta_path, encoding="utf-8") as f:
                existing = json.load(f)
            for key, value in meta.items():
                if key in existing and existing[key] != value:
                    raise ValueError(
                        f"state dir {self.state_dir!r} was created with "
                        f"{key}={existing[key]!r}; this engine is configured "
                        f"with {key}={value!r}")
            return
        tmp = self.meta_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(meta, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.meta_path)
        self._sync_dir()

    # -- journal appends ------------------------------------------------------
    def append_alloc(self, chash: str, *, fn_offset: int, n_fn: int,
                     round_samples: int) -> None:
        self._append({"t": "alloc", "chash": chash,
                      "fn_offset": int(fn_offset), "n_fn": int(n_fn),
                      "round_samples": int(round_samples)})

    def append_grid(self, chash: str, *, parent: str, epoch: int,
                    edges: np.ndarray) -> None:
        """Journal an adapted stream's importance grid (exact f32 edges).

        Must precede the child stream's ``alloc`` record, so replay (and
        the reference auditor's STR007 chain check) sees the grid an
        adapted stream samples through before the stream itself.
        """
        edges = np.ascontiguousarray(edges, np.float32)
        n_fn, dim, nb1 = edges.shape
        self._append({"t": "grid", "chash": chash, "parent": parent,
                      "epoch": int(epoch), "n_fn": int(n_fn),
                      "dim": int(dim), "n_bins": int(nb1 - 1),
                      "edges": _encode_f32(edges.ravel())})

    @staticmethod
    def deposit_record(chash: str, round_index: int,
                       s1: np.ndarray, s2: np.ndarray, n: int) -> dict:
        """The journal payload for one round's delta (see
        :meth:`append_deposits` for group commit)."""
        return {"t": "dep", "chash": chash, "round": int(round_index),
                "n": int(n), "s1": _encode_f32(s1), "s2": _encode_f32(s2)}

    def append_deposits(self, payloads) -> None:
        """Group commit: journal a batch of records with ONE fsync.

        The records become durable atomically-in-order: a crash mid-write
        tears at some record boundary and :meth:`load` truncates from the
        first bad frame, so any durable prefix of the batch is exactly a
        prefix of the deposits — the same crash window as per-record
        appends, amortizing the fsync over a whole wave.
        """
        payloads = list(payloads)
        if not payloads:
            return
        self._write(b"".join(self._frame(p) for p in payloads))

    @staticmethod
    def _frame(payload: dict) -> bytes:
        raw = json.dumps(payload, sort_keys=True,
                         separators=(",", ":")).encode("utf-8")
        return _MAGIC + _HEADER.pack(len(raw), zlib.crc32(raw)) + raw

    def _append(self, payload: dict) -> None:
        self._write(self._frame(payload))

    def _write(self, record: bytes) -> None:
        obs = self.obs
        faults = self.faults
        with self.mutex:
            self.heartbeat()
            t0 = _clock.monotonic()
            with obs.span("wal_commit", bytes=len(record)):
                faults.check("wal_commit")
                f = self._journal()
                start = self._good_size
                try:
                    if faults.enabled and faults.fire("wal_torn_write"):
                        # model a torn write: a prefix of the record
                        # reaches the file, then the device dies
                        from repro_torch.service.faults import InjectedIOError
                        f.write(record[:max(1, len(record) // 2)])
                        f.flush()
                        raise InjectedIOError(
                            errno.ENOSPC, "injected torn journal write")
                    f.write(record)
                    f.flush()
                    faults.check("wal_fsync")
                    if self.fsync:
                        os.fsync(f.fileno())
                except OSError:
                    # fail closed: whatever partial/unsynced bytes this
                    # append left must not become a torn *middle* once a
                    # retry appends after them — rewind to the last
                    # known-good record boundary before surfacing
                    self._rewind(start)
                    raise
                self._good_size = start + len(record)
            obs.m["wal_fsync_seconds"].observe(_clock.monotonic() - t0)
            obs.m["wal_bytes"].inc(len(record))
            obs.m["wal_commits"].inc()

    def _rewind(self, good_size: int) -> None:
        """Truncate the journal back to the last durable record boundary
        after a failed append (best-effort: if even the truncate fails,
        ``load()``'s tail truncation still recovers the prefix)."""
        self._close_journal()
        try:
            with open(self.journal_path, "r+b") as f:
                f.truncate(good_size)
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            pass
        self._good_size = good_size

    def _journal(self):
        if self._journal_f is None or self._journal_f.closed:
            created = not os.path.exists(self.journal_path)
            self._journal_f = open(self.journal_path, "ab")
            self._good_size = self.journal_size()
            if created:
                # fsyncing records is useless if the file's own dirent
                # is lost to a power cut; persist it on first creation
                self._sync_dir()
        return self._journal_f

    def journal_size(self) -> int:
        try:
            return os.path.getsize(self.journal_path)
        except OSError:
            return 0

    # -- recovery -------------------------------------------------------------
    def load(self) -> RecoveredState:
        """Snapshot + journal replay; truncates a bad tail, never raises
        for torn/corrupt journal bytes."""
        state = RecoveredState(entries={})
        if os.path.exists(self.snapshot_path):
            self._load_snapshot(state)
        self._replay_journal(state)
        return state

    def _load_snapshot(self, state: RecoveredState) -> None:
        meta, arrays = read_snapshot(self.snapshot_path)
        state.next_id = int(meta["next_id"])
        state.round_samples = int(meta["round_samples"])
        for i, ent in enumerate(meta["entries"]):
            st = EntryState(
                chash=ent["chash"], fn_offset=int(ent["fn_offset"]),
                n_fn=int(ent["n_fn"]),
                round_samples=int(ent["round_samples"]),
                s1=arrays[f"s1_{i:05d}"],
                s2=arrays[f"s2_{i:05d}"],
                n=int(ent["n"]), rounds_done=int(ent["rounds_done"]))
            state.entries[st.chash] = st
        # pre-adaptive snapshots carry no "grids" key; .get keeps them
        # loading unchanged (the snapshot version is unbumped on purpose)
        for i, g in enumerate(meta.get("grids", [])):
            rec = GridRecord(
                chash=g["chash"], parent=g["parent"],
                epoch=int(g["epoch"]), n_fn=int(g["n_fn"]),
                dim=int(g["dim"]), n_bins=int(g["n_bins"]),
                edges=np.asarray(arrays[f"grid_{i:05d}"], np.float32))
            state.grids[rec.chash] = rec

    def _replay_journal(self, state: RecoveredState) -> None:
        records, bad_tail = read_journal(self.journal_path)
        for record in records:
            self._apply(record, state)
            state.journal_records += 1
        if bad_tail:
            # drop the bad tail on disk too, so new appends framing-align
            state.truncated_bytes = bad_tail
            good_end = self.journal_size() - bad_tail
            self._close_journal()
            with open(self.journal_path, "r+b") as f:
                f.truncate(good_end)
                f.flush()
                os.fsync(f.fileno())
            self._good_size = good_end

    def _apply(self, record: dict, state: RecoveredState) -> None:
        kind = record.get("t")
        if kind == "alloc":
            chash = record["chash"]
            n_fn = int(record["n_fn"])
            if chash not in state.entries:
                state.entries[chash] = EntryState(
                    chash=chash, fn_offset=int(record["fn_offset"]),
                    n_fn=n_fn, round_samples=int(record["round_samples"]),
                    s1=np.zeros(n_fn, np.float32),
                    s2=np.zeros(n_fn, np.float32))
            state.next_id = max(state.next_id,
                                int(record["fn_offset"]) + n_fn)
        elif kind == "dep":
            st = state.entries.get(record["chash"])
            if st is None:
                state.dropped_records += 1
                return
            round_index = int(record["round"])
            if round_index < st.rounds_done:
                return       # snapshot already folded it (benign overlap)
            s1 = _decode_f32(record["s1"])
            s2 = _decode_f32(record["s2"])
            if round_index > st.rounds_done or s1.shape != (st.n_fn,):
                state.dropped_records += 1          # can't fold a gap
                return
            # the same f32 left fold the live cache performed
            st.s1 = st.s1 + s1
            st.s2 = st.s2 + s2
            st.n += int(record["n"])
            st.rounds_done += 1
        elif kind == "grid":
            chash = record["chash"]
            if chash not in state.grids:     # first record wins (refits
                n_fn = int(record["n_fn"])   # open new chashes, so a
                dim = int(record["dim"])     # dup is a replayed wave)
                n_bins = int(record["n_bins"])
                state.grids[chash] = GridRecord(
                    chash=chash, parent=record["parent"],
                    epoch=int(record["epoch"]), n_fn=n_fn, dim=dim,
                    n_bins=n_bins,
                    edges=_decode_f32(record["edges"]).reshape(
                        n_fn, dim, n_bins + 1))
        else:
            state.dropped_records += 1

    # -- compaction -----------------------------------------------------------
    def snapshot(self, states: list[EntryState], *, next_id: int,
                 round_samples: int, grids: list[GridRecord] = ()) -> None:
        """Atomically persist all stream states, then reset the journal.

        ``grids`` carries the adapted streams' importance-grid records;
        compaction must never forget one (a forgotten grid would orphan
        its epoch chain on the next restart).
        """
        payload: dict[str, np.ndarray] = {}
        entries_meta = []
        for i, st in enumerate(states):
            payload[f"s1_{i:05d}"] = np.ascontiguousarray(st.s1, "<f4")
            payload[f"s2_{i:05d}"] = np.ascontiguousarray(st.s2, "<f4")
            entries_meta.append({
                "chash": st.chash, "fn_offset": int(st.fn_offset),
                "n_fn": int(st.n_fn),
                "round_samples": int(st.round_samples),
                "n": int(st.n), "rounds_done": int(st.rounds_done)})
        grids_meta = []
        for i, g in enumerate(grids):
            payload[f"grid_{i:05d}"] = np.ascontiguousarray(g.edges, "<f4")
            grids_meta.append({
                "chash": g.chash, "parent": g.parent,
                "epoch": int(g.epoch), "n_fn": int(g.n_fn),
                "dim": int(g.dim), "n_bins": int(g.n_bins)})
        meta = {"version": _SNAPSHOT_VERSION, "next_id": int(next_id),
                "round_samples": int(round_samples), "entries": entries_meta}
        if grids_meta:
            meta["grids"] = grids_meta
        payload["meta"] = np.frombuffer(
            json.dumps(meta, sort_keys=True).encode("utf-8"), np.uint8)

        tmp = self.snapshot_path + ".tmp"
        with self.mutex:
            self.heartbeat()
            with open(tmp, "wb") as f:
                np.savez(f, **payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snapshot_path)
            self._sync_dir()
            # the snapshot supersedes every journal record; reset it (a
            # crash between replace and reset only costs replay skips)
            self._close_journal()
            with open(self.journal_path, "wb") as f:
                f.flush()
                os.fsync(f.fileno())
            self._good_size = 0

    def _sync_dir(self) -> None:
        try:
            fd = os.open(self.state_dir, os.O_RDONLY)
        except OSError:
            return                                  # platform without dir fds
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _close_journal(self) -> None:
        if self._journal_f is not None and not self._journal_f.closed:
            self._journal_f.close()
        self._journal_f = None

    def close(self) -> None:
        """Release the journal handle and the lease (idempotent)."""
        self._close_journal()
        self._release_lease()


class MeshStore:
    """The durable store of one rank of a mesh: rank 0 owns the state dir.

    The ranks of a mesh work in lockstep and every deposit carries the
    same bits on every rank (the collectives fold in a fixed order), so
    one journal describes every rank's cache.  Rank 0 holds the only
    :class:`DurableStore` (the lease, ``ensure_meta``, the journal, the
    snapshots); the other ranks touch no file.  Every operation that can
    fail — opening (and leasing) the dir, ``ensure_meta``, ``load``,
    each append, ``snapshot``, ``close`` — runs on rank 0 and is then
    followed by a broadcast of its outcome from rank 0, and every rank
    raises the same error (type and message) when it failed, instead of
    waiting in the next collective for a rank that is gone.  ``load``
    broadcasts the recovered state too, so every rank's cache starts
    from rank 0's, bit for bit, and no rank reads a journal rank 0 may
    be writing.  A lease renewal between operations (the worker loop's
    :meth:`heartbeat`) is local to rank 0; its failure is raised, on
    every rank, by the next operation.

    Every rank must call the operations in the same order, which the
    engine's lockstep gives.  Errors are not retried on one rank alone:
    a retry policy sees the same error on every rank.  The broadcasts run
    on the default process group, which the mesh spans; with NCCL the
    rank's card is made the current device first.
    """

    deposit_record = staticmethod(DurableStore.deposit_record)

    def __init__(self, state_dir: str, *, device=None, **store_kw):
        import torch
        import torch.distributed as dist
        self._dist = dist
        self.rank = dist.get_rank()
        self.journal_path = os.path.join(str(state_dir), DurableStore.JOURNAL)
        self._device = None
        if dist.get_backend() == "nccl":
            self._device = torch.device(device if device is not None else "cuda")
            torch.cuda.set_device(self._device)
        # the cache holds this across append + fold, as with DurableStore
        self.mutex = threading.RLock()
        self._deferred: Exception | None = None
        self._store: DurableStore | None = None
        self._store = self._on_rank0(
            lambda: DurableStore(state_dir, **store_kw))

    def _on_rank0(self, fn, *, share: bool = False):
        """Run ``fn`` on rank 0, broadcast its outcome, and raise rank 0's
        error on every rank.  Returns ``fn``'s result: on every rank with
        ``share`` (broadcast with the outcome), else on rank 0 alone."""
        out = err = None
        if self.rank == 0:
            try:
                if self._deferred is not None:
                    err, self._deferred = self._deferred, None
                else:
                    out = fn()
            except Exception as exc:  # noqa: BLE001 - re-raised on every rank below
                err = exc
            try:
                pickle.dumps(err)
            except Exception:  # noqa: BLE001 - any unpicklable error
                err = RuntimeError(f"{type(err).__name__}: {err}")
        box = [err, out if share and err is None else None]
        with self.mutex:
            self._dist.broadcast_object_list(box, src=0, device=self._device)
        if box[0] is not None:
            if self.rank == 0 and err is box[0]:
                raise err
            raise box[0]
        return box[1] if share else out

    # -- the DurableStore operations, rank 0 writing -------------------------
    def ensure_meta(self, meta: dict) -> None:
        self._on_rank0(lambda: self._store.ensure_meta(meta))

    def load(self) -> RecoveredState:
        return self._on_rank0(lambda: self._store.load(), share=True)

    def append_alloc(self, chash: str, **kw) -> None:
        self._on_rank0(lambda: self._store.append_alloc(chash, **kw))

    def append_grid(self, chash: str, **kw) -> None:
        self._on_rank0(lambda: self._store.append_grid(chash, **kw))

    def append_deposits(self, payloads) -> None:
        self._on_rank0(lambda: self._store.append_deposits(payloads))

    def snapshot(self, states, **kw) -> None:
        self._on_rank0(lambda: self._store.snapshot(states, **kw))

    def heartbeat(self) -> None:
        """Renew rank 0's lease (no collective: the worker loop calls this
        a varying number of times per rank); a failure is raised on every
        rank by the next operation."""
        if self._store is None or self._deferred is not None:
            return
        try:
            self._store.heartbeat()
        except (LeaseLost, OSError) as exc:
            self._deferred = exc

    def close(self) -> None:
        self._on_rank0(lambda: self._store.close())

    def journal_size(self) -> int:
        try:
            return os.path.getsize(self.journal_path)
        except OSError:
            return 0
