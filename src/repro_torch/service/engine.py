"""The continuously-batching integration engine (submit/poll worker);
port of ``repro.service.engine``.

Life of a request:

1. **submit** — each family is canonicalized and content-hashed
   (:mod:`repro_torch.service.canonical`); the hash (plus sampler) addresses a
   :class:`~repro_torch.service.cache.CacheEntry`, allocated on first sight
   with its own counter-space range.  If every entry already meets the
   requested precision the result is finalized immediately — a pure
   cache hit, zero launches.  Otherwise the request parks in the pending
   table (bounded: submits beyond ``max_pending`` block, or raise
   :class:`~repro_torch.service.api.Backpressure` when non-blocking).

2. **wave** (``step``) — the engine sweeps the pending table, asks the
   cache how many more rounds each entry needs beyond its fold frontier
   *plus whatever is already in flight*, and assigns the wave's round
   budget **fairly**: requests are visited round-robin (one round per
   stream per pass, rotating the starting request every wave), so when
   ``max_items_per_wave`` bounds the wave, a heavy precision ask can
   never starve a small latency-sensitive one.  The
   :class:`~repro_torch.service.batcher.RoundBatcher` coalesces the wave into
   fused multi-round dimension-bucket launches (an R-round wave over B
   buckets costs B kernel launches).  Each wave runs under the
   :class:`~repro_torch.distributed.fault_tolerance.StepWatchdog` and inside
   :func:`~repro_torch.service.resilience.run_with_policy`: because work
   is counter-addressed and deposits happen only at wave end, a crashed
   wave replays identically.

   The background worker **pipelines** waves (double buffering): wave
   k+1's device work is dispatched while wave k's results transfer and
   group-commit on the host, keeping deposits and WAL journaling off the
   device critical path (``pipeline_waves=False`` restores strictly
   serial waves).  In-flight rounds are tracked per stream so the
   planner schedules beyond them instead of re-planning them.

2b. **adapt** (opt-in) — a request with ``adaptive=True`` and a stderr
   target samples through a VEGAS importance grid
   (:mod:`repro_torch.core.adaptive`): epoch 1 is fit at submit from a
   deterministic counter-keyed pilot, and the planner refits between
   waves while the target is unmet.  Every epoch is a NEW cache stream
   keyed by its grid's edges (the grid record is journaled *before* the
   child's alloc, the STR007 chain), so adapted streams keep the
   bit-identical resume contract: a restarted engine adopts the
   journaled chain tip instead of refitting.

3. **complete** — requests whose entries all meet their precision are
   finalized from the cache accumulators and their tickets released.

``start()`` spawns the worker thread for async submit/poll service;
``step()`` drives the same loop synchronously (tests, batch jobs).

With a ``state_dir``, the cache journals every deposit through a
:class:`~repro_torch.service.store.DurableStore` (replayed on boot, corrupt
tails truncated) and ``stop()``/``close()`` snapshot-compact on
shutdown — so a SIGKILLed engine restarts warm: already-satisfied
requests cost zero launches and partially-met ones top up from their
persisted ``sample_offset`` bit-identically to an uninterrupted run.

A :class:`~repro_torch.service.api.SweepRequest` canonicalizes into
fixed-size slices of swept families (``canonical.sweep_slices``), each
an ordinary cache stream keyed ``f"{family_hash}:{sampler}"``; its
per-point results stream back through :meth:`IntegrationEngine
.sweep_partial` as slices finish.

On a mesh (``mesh=``) every rank runs one engine and the engines work in
**lockstep** (SPMD): each wave's launches end in collectives, so every
rank must submit the same requests in the same order and step the same
waves.  Driving ``step()`` after the same submits does that.  With the
worker thread, submit every request before ``start()``: each rank's one
worker then plans and launches the same waves in the same order.
Request deadlines and retried faults are local to a rank and can break
lockstep; leave them off on a mesh.  A ``state_dir`` on a mesh of more
than one rank is not ported yet (ROADMAP queue 1 item 5) and raises.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import zlib
from typing import Sequence

import numpy as np

from repro_torch.analysis import streams as _analysis
from repro_torch.core import adaptive
from repro_torch.core import rng as rng_lib
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives
from repro_torch.obs import Observability
from repro_torch.obs import clock as _clock
from repro_torch.service.api import (Backpressure, IntegrationRequest,
                                     IntegrationResult, RequestFailed,
                                     SweepRequest, SweepResult)
from repro_torch.service.batcher import InFlightWave, RoundBatcher, WorkItem
from repro_torch.service.cache import CacheEntry, ResultCache
from repro_torch.service.canonical import (DEFAULT_SWEEP_SLICE,
                                           canonical_family, family_hash,
                                           sweep_slices)
from repro_torch.service.faults import NULL_FAULTS, InjectedCrash
from repro_torch.service.resilience import (Deadline, DeadlineExceeded,
                                            RetryExhausted, RetryPolicy,
                                            StepWatchdog, run_with_policy)
from repro_torch.service.store import DurableStore


def _wave_streams(items: Sequence[WorkItem]) -> list[str]:
    """Stable, deduplicated stream-id prefixes for event payloads."""
    seen: list[str] = []
    for it in items:
        sid = it.chash[:16]
        if sid not in seen:
            seen.append(sid)
    return seen


@dataclasses.dataclass
class EngineStats:
    submitted: int = 0
    served: int = 0
    cache_hits: int = 0        # requests served with zero new rounds
    waves: int = 0
    items_executed: int = 0
    items_requested: int = 0   # before cross-request dedup
    restarts: int = 0
    failed: int = 0            # tickets completed as RequestFailed
    deadline_expirations: int = 0

    @property
    def items_deduped(self) -> int:
        return self.items_requested - self.items_executed


@dataclasses.dataclass(frozen=True)
class _SweepInfo:
    """Grid geometry a sweep ticket needs to assemble its result."""
    grid_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    n_points: int
    slice_sizes: tuple[int, ...]   # points per canonical slice, in order
    slice_names: tuple[str, ...]


@dataclasses.dataclass
class _AdaptiveState:
    """Planner-side record of one base stream's importance-grid chain.

    ``chash``/``edges``/``epoch`` track the current (deepest) epoch
    stream; ``base_family`` is the canonical pre-grid family every pilot
    evaluates (pilots never sample through the grid being refit).
    ``frozen`` marks a converged chain (a refit reproduced the current
    edges); it is in memory only, and a resumed engine re-derives it from
    the same deterministic pilot.
    """

    base_chash: str
    base_family: object     # the canonical pre-grid IntegrandFamily
    sampler: str
    epoch: int
    edges: np.ndarray
    chash: str
    family: object          # the current epoch's adapted IntegrandFamily
    frozen: bool = False


@dataclasses.dataclass
class _Pending:
    ticket: int
    request: IntegrationRequest | SweepRequest
    entries: list[CacheEntry]
    event: threading.Event
    result: IntegrationResult | RequestFailed | None = None
    new_rounds_scheduled: bool = False
    deadline: Deadline | None = None
    sweep: _SweepInfo | None = None


class IntegrationEngine:
    """Batching, caching, fault-tolerant integral server.

    ``device`` defaults to ``"cuda"`` and raises when there is no GPU;
    pass ``device="cpu"`` for the plain PyTorch versions of the kernels.
    Families are moved to the device at submit.  With ``mesh`` the device
    is the rank's own, functions shard over ``fn_axis`` and samples over
    ``sample_axes`` (default: every other axis), over which
    ``round_samples`` must divide evenly.
    """

    def __init__(self, *, seed: int = 0, round_samples: int = 65536,
                 use_kernel: bool = True, mesh=None, fn_axis: str = "model",
                 sample_axes: Sequence[str] | None = None, device=None,
                 chunk: int = 8192, max_pending: int = 256,
                 max_rounds_per_wave: int = 8,
                 max_items_per_wave: int | None = None,
                 pipeline_waves: bool = True, max_restarts: int = 2,
                 max_retained_results: int = 4096,
                 watchdog: StepWatchdog | None = None,
                 state_dir: str | None = None,
                 compact_on_start: bool = False,
                 store_fsync: bool = True,
                 obs: Observability | None = None,
                 retry_policy: RetryPolicy | None = None,
                 faults=None, lease_ttl: float | None = 30.0,
                 sweep_slice_points: int = DEFAULT_SWEEP_SLICE,
                 adapt_bins: int = adaptive.N_BINS,
                 adapt_pilot_samples: int = 4096,
                 adapt_max_epochs: int = 3,
                 adapt_rounds_per_epoch: int = 2):
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = collectives.mesh_device(mesh, device)
            if sample_axes is None:
                sample_axes = tuple(a for a in mesh.mesh_dim_names if a != fn_axis)
            sample_par = collectives.axis_size(mesh, sample_axes)
            # the unfused fallback (sharded_family_sums) rounds the budget
            # up to per-shard multiples; an inexact split would draw
            # overlapping counters across consecutive cache rounds
            if round_samples % sample_par:
                raise ValueError(
                    f"round_samples={round_samples} must divide evenly over "
                    f"the {sample_par} sample-axis shards of the mesh")
            if state_dir is not None and mesh.size() > 1:
                raise ValueError(
                    "state_dir on a mesh of more than one rank is not ported "
                    "yet (ROADMAP queue 1 item 5)")
        # telemetry first: every layer below receives the same bundle
        self.obs = obs if obs is not None else Observability.disabled()
        self.seed = int(seed)
        self.key = rng_lib.fold_key(self.seed, 0)
        # the ONE retry policy (rule RES001): `max_restarts` is kept as
        # shorthand for its attempt budget; an explicit policy wins
        if retry_policy is None:
            retry_policy = RetryPolicy(max_attempts=int(max_restarts) + 1,
                                       seed=self.seed)
        self.retry = retry_policy
        self.faults = (NULL_FAULTS if faults is None
                       else faults).bind(self.obs)
        self.store = None
        if state_dir is not None:
            self.store = DurableStore(state_dir, fsync=store_fsync,
                                      obs=self.obs, faults=self.faults,
                                      lease_ttl=lease_ttl)
        self.cache = ResultCache(round_samples=round_samples,
                                 store=self.store, obs=self.obs)
        self.batcher = RoundBatcher(
            self.cache, self.key, use_kernel=use_kernel, mesh=mesh,
            fn_axis=fn_axis, sample_axes=sample_axes or ("data",),
            chunk=chunk, obs=self.obs, faults=self.faults)
        if self.store is not None:
            # only after every constructor check passed: a rejected
            # configuration must not pin meta into a fresh state dir.
            # A state dir replays one counter stream — same seed, same
            # round quantization, or the resumed samples would differ.
            self.store.ensure_meta({"seed": self.seed,
                                    "round_samples": int(round_samples)})
            if compact_on_start:
                self.cache.snapshot_to_store()
        if int(sweep_slice_points) < 1:
            raise ValueError("sweep_slice_points must be >= 1")
        # part of the dedupe contract: engines chunking at different
        # quanta never share sweep streams (see canonical.sweep_slices)
        self.sweep_slice_points = int(sweep_slice_points)
        self.max_pending = int(max_pending)
        self.max_rounds_per_wave = int(max_rounds_per_wave)
        if max_items_per_wave is not None and int(max_items_per_wave) <= 0:
            # 0 would silently mean "unbounded" in the planner's
            # truthiness check — reject it loudly instead
            raise ValueError("max_items_per_wave must be positive "
                             "(or None for unbounded)")
        self.max_items_per_wave = (None if max_items_per_wave is None
                                   else int(max_items_per_wave))
        self.pipeline_waves = bool(pipeline_waves)
        self.max_restarts = self.retry.max_attempts - 1
        self.max_retained_results = int(max_retained_results)
        self.watchdog = watchdog if watchdog is not None else StepWatchdog()
        # importance-grid adaptation knobs: pilots and refit cadence are
        # deterministic in (seed, base stream, epoch) and the durable
        # rounds_done, so two engines with the same knobs replay the same
        # epoch chain
        if int(adapt_bins) < 2:
            raise ValueError("adapt_bins must be >= 2")
        if int(adapt_max_epochs) < 1 or int(adapt_rounds_per_epoch) < 1:
            raise ValueError("adapt_max_epochs and adapt_rounds_per_epoch "
                             "must be >= 1")
        self.adapt_bins = int(adapt_bins)
        self.adapt_pilot_samples = int(adapt_pilot_samples)
        self.adapt_max_epochs = int(adapt_max_epochs)
        self.adapt_rounds_per_epoch = int(adapt_rounds_per_epoch)
        self._adaptive: dict[str, _AdaptiveState] = {}
        self.stats = EngineStats()

        self._pending: dict[int, _Pending] = {}
        # FIFO-bounded: a continuously-serving engine must not retain
        # every result ever served; clients that care call release()
        self._results: collections.OrderedDict[int, IntegrationResult] = \
            collections.OrderedDict()
        self._next_ticket = 0
        # rounds dispatched but not yet deposited, per stream: the
        # planner schedules *beyond* these (pipelined waves, racing
        # step() drivers) instead of re-planning them
        self._inflight: dict[str, int] = {}
        self._rr_cursor = 0
        self._wave_seq = 0
        self._lock = threading.RLock()
        self._work_cv = threading.Condition(self._lock)
        self._space_cv = threading.Condition(self._lock)
        self._deposit_cv = threading.Condition(self._lock)
        self._worker: threading.Thread | None = None
        self._stop = False
        # armed by the first completed stop(): makes stop()/close()
        # re-entrant (second call is a no-op, no double snapshot)
        self._shutdown = False

    # -- submit / poll --------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    def submit(self, request: IntegrationRequest | SweepRequest, *,
               block: bool = True, timeout: float | None = None) -> int:
        """Register a request; returns a ticket for :meth:`poll`/:meth:`result`.

        Accepts both request shapes: a :class:`SweepRequest` goes to
        :meth:`submit_sweep`.  Pure cache hits complete inline (no
        waiting, no launches, and no pending-table space needed).
        Otherwise, when the pending table is full, blocks until space
        frees up — or raises :class:`Backpressure` with ``block=False``.
        A rejected submit allocates nothing: counter-space ranges are
        only consumed once the request is accepted.
        """
        if isinstance(request, SweepRequest):
            return self.submit_sweep(request, block=block, timeout=timeout)
        # adaptation needs a precision target to chase (a pure sample
        # budget has nothing to adapt toward, so the flag is ignored) and
        # never applies to swept families (the sweep table and the grid
        # would compete for the packed row)
        adapt = bool(request.adaptive and request.target_stderr is not None)
        canon_fams = []
        for fam in request.families:
            canon = canonical_family(fam)
            chash = f"{family_hash(canon, canonicalize=False)}:{request.sampler}"
            canon = canon.to(self.device)
            if adapt and not canon.swept:
                with self._lock:
                    ast = self._adaptive_state(chash, canon, request.sampler)
                canon_fams.append((ast.chash, ast.family))
            else:
                canon_fams.append((chash, canon))
        return self._submit_canonical(request, canon_fams, block=block,
                                      timeout=timeout)

    def submit_sweep(self, request: SweepRequest, *, block: bool = True,
                     timeout: float | None = None) -> int:
        """Register a parameter sweep; returns a ticket like :meth:`submit`.

        The grid canonicalizes into ``sweep_slice_points``-sized slices of
        swept families (``canonical.sweep_slices``), each one cache
        stream, so placement, top-up, persistence and the STR rules apply
        per slice unchanged and an overlapping sweep from another client
        dedupes onto the shared slices.  When the template names a
        registered form, the (dim, sampler, compactified, sweep)
        capability is checked here with ``registry.lookup(...,
        required=True)``: a sweep the fused kernel cannot serve fails at
        submit, naming the nearest supported combination.
        """
        with self.obs.span("sweep_plan", template=request.template.name,
                           axes=len(request.grid)):
            fams, shape, axis_names = sweep_slices(
                request.template, request.grid,
                slice_points=self.sweep_slice_points)
            probe = fams[0]
            if probe.kernel is not None:
                from repro_torch.kernels import registry
                if registry.form(probe.kernel) is not None:
                    registry.lookup(probe.kernel, dim=probe.dim,
                                    sampler=request.sampler,
                                    compactified=probe.compact,
                                    sweep=probe.swept, required=True)
            canon_fams = [
                (f"{family_hash(f, canonicalize=False)}:{request.sampler}",
                 f.to(self.device)) for f in fams]
        n_points = math.prod(shape)
        shared = sum(1 for chash, f in canon_fams
                     if self.cache.get(chash, f) is not None)
        self.obs.m["sweep_submitted"].inc()
        self.obs.m["sweep_points"].inc(n_points)
        if shared:
            self.obs.m["sweep_slices"].inc(shared, outcome="shared")
        if len(canon_fams) - shared:
            self.obs.m["sweep_slices"].inc(len(canon_fams) - shared,
                                           outcome="new")
        sweep = _SweepInfo(grid_shape=shape, axis_names=axis_names,
                           n_points=n_points,
                           slice_sizes=tuple(f.n_fn for f in fams),
                           slice_names=tuple(f.name for f in fams))
        return self._submit_canonical(request, canon_fams, block=block,
                                      timeout=timeout, sweep=sweep)

    def _submit_canonical(self, request, canon_fams, *, block: bool,
                          timeout: float | None,
                          sweep: _SweepInfo | None = None) -> int:
        """Shared tail of :meth:`submit`/:meth:`submit_sweep`: cache-hit
        peek, pending-table admission, allocation."""
        # hit path needs no allocation: all entries must already exist
        # (a persisted stream from a previous process counts — passing
        # the family lets the cache rehydrate it, so a warm *restart*
        # serves satisfied requests with zero launches too)
        peek = [self.cache.get(chash, canon) for chash, canon in canon_fams]
        if all(e is not None for e in peek):
            req = request
            if all(self.cache.meets(e, target_stderr=req.target_stderr,
                                    n_samples=req.n_samples) for e in peek):
                with self._lock:
                    ticket = self._new_ticket()
                    pend = _Pending(ticket=ticket, request=request,
                                    entries=list(peek),
                                    event=threading.Event(), sweep=sweep)
                    self.stats.cache_hits += 1
                    self.obs.m["cache_requests"].inc(outcome="hit")
                    self._finish(pend, served_from_cache=True)
                return ticket

        with self._lock:
            while len(self._pending) >= self.max_pending:
                if not block:
                    raise Backpressure(
                        f"{len(self._pending)} requests pending "
                        f"(max_pending={self.max_pending})")
                if not self._space_cv.wait(timeout=timeout):
                    raise Backpressure("timed out waiting for pending space")
            entries = [self.cache.get_or_allocate(chash, canon)
                       for chash, canon in canon_fams]
            ticket = self._new_ticket()
            budget = getattr(request, "deadline", None)
            pend = _Pending(ticket=ticket, request=request, entries=entries,
                            event=threading.Event(), sweep=sweep,
                            deadline=(None if budget is None
                                      else Deadline(budget)))
            if self._meets(pend):     # became satisfiable while we waited
                self.stats.cache_hits += 1
                self.obs.m["cache_requests"].inc(outcome="hit")
                self._finish(pend, served_from_cache=True)
                return ticket
            self.obs.m["cache_requests"].inc(outcome="miss")
            self._pending[ticket] = pend
            self.obs.m["pending"].set(len(self._pending))
            self._work_cv.notify_all()
        return ticket

    def _new_ticket(self) -> int:
        ticket = self._next_ticket
        self._next_ticket += 1
        self.stats.submitted += 1
        self.obs.m["submitted"].inc()
        return ticket

    def poll(self, ticket: int) -> IntegrationResult | None:
        """Finished result for ``ticket``, or None while in flight.

        Results are retained FIFO up to ``max_retained_results``;
        long-lived clients should :meth:`release` tickets they are done
        with rather than rely on retention.
        """
        with self._lock:
            return self._results.get(ticket)

    def sweep_partial(self, ticket: int,
                      since: np.ndarray | None = None) -> SweepResult:
        """Per-point snapshot of a sweep, streamed as rounds complete.

        Non-blocking: for a finished sweep this is the final
        :class:`SweepResult`; while in flight it carries the current
        estimate of every point whose slice has deposited at least one
        round (``points_done`` marks them; undone points hold NaN means
        and inf stderrs) with ``complete=False``.

        ``since`` makes the poll incremental: pass the previous snapshot's
        ``points_done`` and only slices with points not yet covered by it
        are finalized; an already-reported slice is marked done with
        NaN/inf placeholders (the caller keeps its previous values).
        """
        with self._lock:
            res = self._results.get(ticket)
            if res is None:
                pend = self._pending.get(ticket)
                if pend is None:
                    raise KeyError(f"unknown ticket {ticket}")
                if pend.sweep is None:
                    raise TypeError(f"ticket {ticket} is not a sweep")
                sw = pend.sweep
                if since is not None:
                    since = np.asarray(since, bool)
                    if since.shape != (sw.n_points,):
                        raise ValueError(
                            f"since mask has shape {since.shape}; expected "
                            f"({sw.n_points},) — pass the previous "
                            f"snapshot's points_done unchanged")
                means, errs, done = [], [], []
                offset = 0
                for entry, size in zip(pend.entries, sw.slice_sizes):
                    # explicit per-slice extent: the last slice of a grid
                    # that is not a multiple of the slice quantum is short
                    seen = (since is not None
                            and bool(np.all(since[offset:offset + size])))
                    offset += size
                    if entry.rounds_done > 0:
                        done.append(np.ones(size, bool))
                        if seen:
                            means.append(np.full(size, np.nan, np.float32))
                            errs.append(np.full(size, np.inf, np.float32))
                        else:
                            snap = entry.finalize()
                            means.append(np.asarray(snap.mean))
                            errs.append(np.asarray(snap.stderr))
                    else:
                        means.append(np.full(size, np.nan, np.float32))
                        errs.append(np.full(size, np.inf, np.float32))
                        done.append(np.zeros(size, bool))
                return SweepResult(
                    means=np.concatenate(means),
                    stderrs=np.concatenate(errs),
                    n_per_family=tuple(e.n for e in pend.entries),
                    names=sw.slice_names, served_from_cache=False,
                    ticket=ticket,
                    stream_ids=tuple(e.chash for e in pend.entries),
                    grid_shape=sw.grid_shape, axis_names=sw.axis_names,
                    n_points=sw.n_points,
                    points_done=np.concatenate(done), complete=False)
        if not isinstance(res, SweepResult):
            raise TypeError(f"ticket {ticket} is not a sweep")
        return res

    def release(self, ticket: int) -> None:
        """Drop a finished result the client no longer needs."""
        with self._lock:
            self._results.pop(ticket, None)

    def result(self, ticket: int,
               timeout: float | None = None) -> IntegrationResult:
        """Block until ``ticket`` finishes (worker thread must be running
        or another thread driving :meth:`step`).

        A request that failed permanently (retry budget exhausted,
        deadline expired, stream quarantined) returns its structured
        :class:`~repro_torch.service.api.RequestFailed` — a completed ticket,
        not a hang.
        """
        with self._lock:
            res = self._results.get(ticket)
            if res is not None:
                return res
            pend = self._pending.get(ticket)
        if pend is None:
            raise KeyError(f"unknown ticket {ticket}")
        if not pend.event.wait(timeout=timeout):
            with self._lock:
                state = ("pending" if ticket in self._pending
                         else "completing")
                rounds = [e.rounds_done for e in pend.entries]
            raise TimeoutError(
                f"ticket {ticket} still {state} after {timeout:g}s "
                f"(worker {'running' if self.running else 'NOT running'}, "
                f"rounds folded per stream: {rounds})")
        return pend.result

    # -- the wave loop --------------------------------------------------------
    def step(self) -> bool:
        """Run one batching wave synchronously.

        Returns True when work was executed (or is executing in another
        driver's wave), False when the pending table made no progress
        (empty or already satisfiable).
        """
        with self._lock:
            with self.obs.span("plan", pending=len(self._pending)):
                items = self._plan_wave()
            if not items:
                self._complete_ready()
                if self._awaiting_other_driver_locked():
                    # every remaining round is in another driver's wave;
                    # wait for a deposit instead of claiming deadlock
                    self._deposit_cv.wait(timeout=1.0)
                    return True
                return False
            seq = self._wave_seq
            self._wave_seq += 1

        def wave(attempt: int) -> int:
            if attempt:
                with self._lock:
                    self.stats.restarts += 1
                self.obs.m["retries"].inc(stage="wave")
            self.faults.check("plan")
            with self.watchdog:
                return self.batcher.execute(items)

        t0 = _clock.monotonic()
        stragglers_before = self.watchdog.straggler_count
        try:
            executed = run_with_policy(
                wave, self.retry, stage="wave", counter=seq,
                deadline=self._wave_deadline(items),
                on_retry=self._restart_hook("wave_restart", seq, items))
        except (RetryExhausted, DeadlineExceeded) as exc:
            # the wave is permanently lost: complete its tickets with a
            # structured failure, then surface the error to this
            # synchronous driver (async drivers swallow and move on)
            with self._lock:
                self._retire_items(items)
                self._fail_wave(items, exc)
            raise
        except Exception:
            with self._lock:
                self._retire_items(items)
            raise
        self._note_stragglers(stragglers_before, seq, items)
        self.obs.m["waves"].inc()
        self.obs.m["wave_seconds"].observe(_clock.monotonic() - t0)
        with self._lock:
            self._retire_items(items)
            self.stats.waves += 1
            self.stats.items_executed += executed
            self._complete_ready()
        return True

    # -- telemetry hooks ------------------------------------------------------
    def _restart_hook(self, kind: str, seq: int,
                      items: Sequence[WorkItem]):
        """on_restart callback emitting a structured event carrying the
        wave sequence number and the affected stream identities."""
        def on_restart(attempt: int, exc: Exception) -> None:
            self.obs.m["restarts"].inc()
            self.obs.event(kind, wave=seq, attempt=attempt,
                           error=type(exc).__name__,
                           streams=_wave_streams(items))
        return on_restart

    def _note_stragglers(self, before: int, seq: int,
                         items: Sequence[WorkItem]) -> None:
        """Emit one instant event per watchdog straggler the wave added."""
        new = self.watchdog.straggler_count - before
        if new <= 0:
            return
        self.obs.m["stragglers"].inc(new)
        for ev in self.watchdog.events[-new:]:
            self.obs.event("straggler", wave=seq, step=ev.step,
                           duration=ev.duration, median=ev.median,
                           streams=_wave_streams(items))

    def stderr_trajectory(self, chash: str):
        """Per-stream convergence record: the stderr-vs-rounds trajectory
        observed at deposit time (requires convergence recording, i.e. an
        engine built with ``Observability.enabled()``).  ``chash`` is a
        stream id as reported by ``IntegrationResult.stream_ids``."""
        return self.obs.convergence.trajectory(chash)

    def _awaiting_other_driver_locked(self) -> bool:
        return any(self._inflight.get(e.chash) for p in self._pending.values()
                   for e in p.entries)

    # -- failure surfacing ----------------------------------------------------
    def _wave_deadline(self, items: Sequence[WorkItem]) -> Deadline | None:
        """Tightest remaining per-request deadline riding this wave, as
        a fresh budget for the retry loop (None when no rider has one)."""
        streams = {it.chash for it in items}
        with self._lock:
            remains = [p.deadline.remaining()
                       for p in self._pending.values()
                       if p.deadline is not None
                       and any(e.chash in streams for e in p.entries)]
        if not remains:
            return None
        return Deadline(max(min(remains), 1e-9))

    def _fail_wave(self, items: Sequence[WorkItem], exc: Exception) -> None:
        """Complete the tickets a permanently-failed wave was serving
        with a structured :class:`RequestFailed` (caller holds the lock).

        A :class:`DeadlineExceeded` fails only the riders whose own
        deadline ran out — other requests on the same streams simply get
        rescheduled; :class:`RetryExhausted` fails every rider.
        """
        streams = {it.chash for it in items}
        riders = [p for p in self._pending.values()
                  if any(e.chash in streams for e in p.entries)]
        if isinstance(exc, DeadlineExceeded):
            riders = [p for p in riders
                      if p.deadline is not None and p.deadline.expired]
            reason = "deadline"
        else:
            reason = "retry_exhausted"
        for pend in riders:
            del self._pending[pend.ticket]
            if reason == "deadline":
                self.stats.deadline_expirations += 1
                self.obs.m["deadline_expirations"].inc()
            self._fail(pend, reason=reason,
                       stage=getattr(exc, "stage", None),
                       attempts=getattr(exc, "attempts", 0),
                       message=str(exc))
        if riders:
            self.obs.m["pending"].set(len(self._pending))
            self._space_cv.notify_all()

    def _fail(self, pend: _Pending, *, reason: str, stage: str | None = None,
              attempts: int = 0, message: str = "") -> None:
        """Terminal completion of one ticket as ``RequestFailed``
        (caller holds the lock)."""
        pend.result = RequestFailed(
            ticket=pend.ticket, reason=reason, stage=stage,
            attempts=attempts, message=message,
            stream_ids=tuple(e.chash for e in pend.entries))
        self._results[pend.ticket] = pend.result
        while len(self._results) > self.max_retained_results:
            self._results.popitem(last=False)
        self.stats.failed += 1
        self.obs.event("request_failed", ticket=pend.ticket, reason=reason,
                       stage=stage, streams=[c[:16]
                                             for c in pend.result.stream_ids])
        pend.event.set()

    # -- importance-grid adaptation -------------------------------------------
    def _pilot_key(self, base_chash: str, epoch: int) -> tuple:
        """Counter key of the (base stream, epoch) pilot wave: folded onto
        a stream id from the base hash and the epoch being fit, so pilot
        counters never collide with the main sample streams (stream 0) and
        a resumed planner draws the identical pilot."""
        sid = zlib.crc32(f"adapt:{base_chash}:{int(epoch)}".encode())
        return rng_lib.fold_key(self.seed, sid)

    def _adaptive_state(self, base_chash: str, canon,
                        sampler: str) -> _AdaptiveState:
        """Active importance-grid state of one base stream (caller holds
        the lock).

        Resume first: when the WAL or snapshot carries an epoch chain
        rooted at ``base_chash`` the planner adopts its tip (recorded
        chash, recorded edges), so the resumed stream samples through
        exactly the journaled grid.  Otherwise epoch 1 is fit here, at
        submit, from a deterministic pilot, and its grid is journaled
        before the child stream's alloc (STR007).
        """
        ast = self._adaptive.get(base_chash)
        if ast is not None:
            return ast
        tip = self.cache.grid_tip(base_chash)
        if tip is not None:
            ast = _AdaptiveState(
                base_chash=base_chash, base_family=canon, sampler=sampler,
                epoch=tip.epoch, edges=np.asarray(tip.edges),
                chash=tip.chash, family=canon.adapted(tip.edges,
                                                      epoch=tip.epoch))
        else:
            edges = adaptive.initial_edges(canon.domains, self.adapt_bins)
            weights = adaptive.pilot_weights(
                canon, edges, self._pilot_key(base_chash, 1),
                self.adapt_pilot_samples)
            edges = adaptive.refine_edges(edges, weights)
            fam = canon.adapted(edges, epoch=1)
            chash = f"{family_hash(fam, canonicalize=False)}:{sampler}"
            self.cache.register_grid(chash, parent=base_chash, epoch=1,
                                     edges=edges)
            self.obs.m["adapted_streams"].inc()
            ast = _AdaptiveState(
                base_chash=base_chash, base_family=canon, sampler=sampler,
                epoch=1, edges=edges, chash=chash, family=fam)
        self._adaptive[base_chash] = ast
        return ast

    def _maybe_refit_locked(self) -> None:
        """Open the next grid epoch for adapted streams still chasing
        their stderr target (caller holds the lock).

        Every trigger input is durable or deterministic (the epoch
        stream's WAL-recovered ``rounds_done``, the riders' targets, a
        pilot keyed by (seed, base stream, epoch)), so a SIGKILLed engine
        re-decides the identical chain.  Refits fire at a wave boundary
        with nothing in flight on the stream; the new epoch is a NEW cache
        stream (grid journaled first, STR007) and every pending holding
        the old entry moves to the child, so results finalize from the
        last epoch only.  A refit that reproduces the current edges
        freezes the chain.
        """
        for ast in self._adaptive.values():
            if ast.frozen or ast.epoch >= self.adapt_max_epochs:
                continue
            if self._inflight.get(ast.chash):
                continue
            entry = self.cache.get(ast.chash)
            if entry is None or entry.quarantined:
                continue
            if entry.rounds_done < self.adapt_rounds_per_epoch:
                continue
            targets = [p.request.target_stderr
                       for p in self._pending.values()
                       if p.request.target_stderr is not None
                       and any(e.chash == ast.chash for e in p.entries)]
            if not targets:
                continue    # no rider is still chasing precision
            if self.cache.meets(entry, target_stderr=min(targets),
                                n_samples=None):
                continue    # met: _complete_ready finishes the riders
            epoch = ast.epoch + 1
            weights = adaptive.pilot_weights(
                ast.base_family, ast.edges,
                self._pilot_key(ast.base_chash, epoch),
                self.adapt_pilot_samples)
            edges = adaptive.refine_edges(ast.edges, weights)
            if np.array_equal(edges, ast.edges):
                ast.frozen = True    # a resume re-derives this verdict
                continue
            fam = ast.base_family.adapted(edges, epoch=epoch)
            chash = f"{family_hash(fam, canonicalize=False)}:{ast.sampler}"
            self.cache.register_grid(chash, parent=ast.chash, epoch=epoch,
                                     edges=edges)
            child = self.cache.get_or_allocate(chash, fam)
            for pend in self._pending.values():
                pend.entries = [child if e.chash == ast.chash else e
                                for e in pend.entries]
            self.obs.m["adapted_streams"].inc()
            self.obs.m["grid_refits"].inc()
            self.obs.event("grid_refit", base=ast.base_chash[:16],
                           parent=ast.chash[:16], stream=chash[:16],
                           epoch=epoch)
            ast.chash, ast.edges, ast.epoch, ast.family = \
                chash, edges, epoch, fam

    def _plan_wave(self) -> list[WorkItem]:
        """Assign the wave's round budget fairly across pending requests.

        Needs are computed beyond each stream's fold frontier plus rounds
        already in flight (a pipelined or racing wave).  Allocation is
        round-robin — one round per stream per pass, the starting stream
        rotating every wave — so with a bounded ``max_items_per_wave``
        every pending request makes progress every wave: heavy precision
        asks cannot monopolize the budget.  Scheduled rounds are
        registered in-flight; callers retire them after deposit (or on
        permanent failure).  Caller must hold the engine lock.
        """
        if self._adaptive:
            self._maybe_refit_locked()
        info: dict[str, dict] = {}
        order: list[str] = []
        for pend in self._pending.values():
            if pend.deadline is not None and pend.deadline.expired:
                continue     # _complete_ready fails it; no more rounds
            req = pend.request
            for entry in pend.entries:
                if entry.quarantined:
                    continue  # poison ladder: stream is unschedulable
                inflight = self._inflight.get(entry.chash, 0)
                raw = self.cache.rounds_needed(
                    entry, target_stderr=req.target_stderr,
                    n_samples=req.n_samples, max_rounds=1 << 16)
                need = min(max(0, raw - inflight), self.max_rounds_per_wave)
                if need or inflight:
                    # rounds are being computed on this request's behalf
                    pend.new_rounds_scheduled = True
                self.stats.items_requested += need
                rec = info.get(entry.chash)
                if rec is None:
                    info[entry.chash] = {"entry": entry,
                                         "sampler": req.sampler,
                                         "need": need}
                    order.append(entry.chash)
                else:
                    rec["need"] = max(rec["need"], need)
        if not any(info[c]["need"] for c in order):
            return []

        budget = (self.max_items_per_wave if self.max_items_per_wave
                  else (1 << 62))
        alloc = dict.fromkeys(order, 0)
        start = self._rr_cursor % len(order)
        self._rr_cursor += 1
        progress = True
        while budget > 0 and progress:
            progress = False
            for k in range(len(order)):
                chash = order[(start + k) % len(order)]
                if alloc[chash] < info[chash]["need"] and budget > 0:
                    alloc[chash] += 1
                    budget -= 1
                    progress = True

        items: list[WorkItem] = []
        for chash in order:
            if not alloc[chash]:
                continue
            rec = info[chash]
            frontier = (rec["entry"].rounds_done
                        + self._inflight.get(chash, 0))
            items.extend(
                WorkItem(chash=chash, round_index=r, sampler=rec["sampler"])
                for r in range(frontier, frontier + alloc[chash]))
            self._inflight[chash] = (self._inflight.get(chash, 0)
                                     + alloc[chash])
        self.obs.m["inflight"].set(sum(self._inflight.values()))
        return items

    def _retire_items(self, items: Sequence[WorkItem]) -> None:
        """Drop items from the in-flight table (deposited or abandoned).
        Caller must hold the engine lock."""
        for it in items:
            left = self._inflight.get(it.chash, 0) - 1
            if _analysis.asserts_enabled():
                # a negative in-flight count means a wave was retired
                # twice — the precursor of double-scheduling its rounds
                _analysis.assert_inflight_consistent(it.chash[:16], left)
            if left > 0:
                self._inflight[it.chash] = left
            else:
                self._inflight.pop(it.chash, None)
        self.obs.m["inflight"].set(sum(self._inflight.values()))
        self._deposit_cv.notify_all()

    def _meets(self, pend: _Pending) -> bool:
        req = pend.request
        return all(
            self.cache.meets(e, target_stderr=req.target_stderr,
                             n_samples=req.n_samples)
            for e in pend.entries)

    def _complete_ready(self) -> None:
        done = [p for p in self._pending.values() if self._meets(p)]
        for pend in done:
            del self._pending[pend.ticket]
            self._finish(pend,
                         served_from_cache=not pend.new_rounds_scheduled)
        # graceful degradation, terminal branch: a pending that can
        # never be met — its stream quarantined, or its deadline gone —
        # completes as RequestFailed instead of parking forever
        failed = []
        for pend in self._pending.values():
            bad = [e.chash[:16] for e in pend.entries if e.quarantined]
            if bad:
                failed.append((pend, "quarantined",
                               f"stream(s) {', '.join(bad)} quarantined "
                               f"after repeated non-finite deposits"))
            elif pend.deadline is not None and pend.deadline.expired:
                failed.append((pend, "deadline",
                               f"deadline budget {pend.deadline.budget:g}s "
                               f"expired"))
        for pend, reason, message in failed:
            del self._pending[pend.ticket]
            if reason == "deadline":
                self.stats.deadline_expirations += 1
                self.obs.m["deadline_expirations"].inc()
            self._fail(pend, reason=reason, message=message)
        if done or failed:
            self.obs.m["pending"].set(len(self._pending))
            self._space_cv.notify_all()

    def _finish(self, pend: _Pending, *, served_from_cache: bool) -> None:
        means, errs = [], []
        for entry in pend.entries:
            res = entry.finalize()
            means.append(np.asarray(res.mean))
            errs.append(np.asarray(res.stderr))
        if pend.sweep is not None:
            sw = pend.sweep
            pend.result = SweepResult(
                means=np.concatenate(means), stderrs=np.concatenate(errs),
                n_per_family=tuple(e.n for e in pend.entries),
                names=sw.slice_names,
                served_from_cache=served_from_cache, ticket=pend.ticket,
                stream_ids=tuple(e.chash for e in pend.entries),
                grid_shape=sw.grid_shape, axis_names=sw.axis_names,
                n_points=sw.n_points,
                points_done=np.ones(sw.n_points, bool), complete=True)
        else:
            pend.result = IntegrationResult(
                means=np.concatenate(means), stderrs=np.concatenate(errs),
                n_per_family=tuple(e.n for e in pend.entries),
                names=tuple(f.name for f in pend.request.families),
                served_from_cache=served_from_cache, ticket=pend.ticket,
                stream_ids=tuple(e.chash for e in pend.entries))
        self._results[pend.ticket] = pend.result
        while len(self._results) > self.max_retained_results:
            self._results.popitem(last=False)
        self.stats.served += 1
        self.obs.m["served"].inc()
        if served_from_cache:
            self.obs.m["warm_zero_launch"].inc()
        pend.event.set()

    # -- background worker ----------------------------------------------------
    def start(self) -> None:
        """Spawn the worker thread (idempotent)."""
        with self._lock:
            if self.running:
                return
            self._stop = False
            self._shutdown = False
            self._worker = threading.Thread(
                target=self._run, name="integration-engine", daemon=True)
            self._worker.start()

    def stop(self, timeout: float | None = 30.0) -> None:
        """Stop the worker and snapshot (re-entrant: a second stop()
        after a completed one is a no-op — no double snapshot)."""
        with self._lock:
            if self._shutdown and self._worker is None:
                return
            self._stop = True
            self._work_cv.notify_all()
            worker = self._worker
        if worker is not None:
            worker.join(timeout=timeout)
            if worker.is_alive():
                # mid-wave; keep the handle so running stays True and a
                # start() cannot spawn a second concurrent worker
                raise TimeoutError(
                    "worker still executing a wave; it will exit at the "
                    "wave boundary (retry stop())")
            self._worker = None
        # snapshot-on-shutdown: compact the journal once no worker can
        # deposit anymore (a kill before this point only costs replay)
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
        self.checkpoint()

    def checkpoint(self) -> None:
        """Compact accumulated state into an atomic snapshot (no-op
        without a ``state_dir``).  Safe at any wave boundary."""
        if self.store is not None:
            self.cache.snapshot_to_store()

    def close(self, timeout: float | None = 30.0) -> None:
        """Clean shutdown: stop the worker, snapshot, release the store.

        If the worker outlives ``timeout`` the TimeoutError from
        :meth:`stop` still propagates, but the store handle is released
        regardless — the journal already holds every folded round, so
        skipping the shutdown snapshot costs replay time, never data.
        """
        try:
            self.stop(timeout=timeout)
        finally:
            if self.store is not None:
                self.store.close()

    def __enter__(self) -> "IntegrationEngine":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def drain(self, timeout: float | None = None) -> None:
        """Block until the pending table is empty (worker running)."""
        events = []
        with self._lock:
            events = [p.event for p in self._pending.values()]
        for ev in events:
            if not ev.wait(timeout=timeout):
                raise TimeoutError("pending requests did not drain")

    def _run(self) -> None:
        try:
            if self.pipeline_waves:
                self._run_pipelined()
                return
            while True:
                if self.store is not None:
                    self.store.heartbeat()   # idle engines keep the lease
                self.faults.check("worker_crash")
                with self._lock:
                    while not self._pending and not self._stop:
                        self._work_cv.wait(timeout=0.5)
                    if self._stop:
                        return
                try:
                    self.step()
                except (RetryExhausted, DeadlineExceeded):
                    # step() already completed the affected tickets as
                    # RequestFailed; the worker keeps serving the rest
                    continue
        except InjectedCrash as exc:
            # chaos: the worker dies at a wave boundary like a real
            # thread crash would — durable state is intact, a driver
            # can resume via step() or a fresh start()
            self.obs.event("worker_crash", error=str(exc))

    def _run_pipelined(self) -> None:
        """Double-buffered wave loop: dispatch wave k+1, then deposit
        wave k.

        ``launch`` only enqueues the card's work (kernels, then the copies
        of their outputs to the host), so by the time ``deposit`` waits on
        wave k's CUDA event the card is already running wave k+1 — host-side folding, group-commit
        journaling and request completion all run off the device
        critical path.  Deposits stay in wave order, so the cache's
        in-order fold and the WAL's crash window are exactly those of
        the serial loop.  On ``stop()`` the tail wave is deposited
        before the worker exits.
        """
        inflight: tuple[InFlightWave, list[WorkItem], float, int] | None = \
            None
        while True:
            if self.store is not None:
                self.store.heartbeat()       # idle engines keep the lease
            if inflight is None:
                # wave boundary with nothing salvageable in flight: the
                # only spot where an injected worker death is loss-free
                self.faults.check("worker_crash")
            with self._lock:
                while (not self._pending and inflight is None
                       and not self._stop):
                    self._work_cv.wait(timeout=0.5)
                if self._stop and inflight is None:
                    return
                if self._stop:
                    items = []
                else:
                    with self.obs.span("plan", pending=len(self._pending)):
                        items = self._plan_wave()
                if not items and inflight is None:
                    self._complete_ready()
                    if self._pending:
                        # nothing plannable here, rounds owed to another
                        # driver's wave: wait for its deposit
                        self._deposit_cv.wait(timeout=0.5)
                    continue
                seq = self._wave_seq
                if items:
                    self._wave_seq += 1

            handle = None
            t0 = _clock.monotonic()
            if items:
                def launch(attempt: int, _items=items) -> InFlightWave:
                    if attempt:
                        with self._lock:
                            self.stats.restarts += 1
                        self.obs.m["retries"].inc(stage="launch")
                    self.faults.check("plan")
                    with self.watchdog:
                        return self.batcher.launch(_items)

                stragglers_before = self.watchdog.straggler_count
                try:
                    handle = run_with_policy(
                        launch, self.retry, stage="launch", counter=seq,
                        deadline=self._wave_deadline(items),
                        on_retry=self._restart_hook(
                            "wave_restart", seq, items))
                except (RetryExhausted, DeadlineExceeded) as exc:
                    # permanent: complete the riders as RequestFailed
                    # and keep serving — the sibling wave deposits below
                    with self._lock:
                        self._retire_items(items)
                        self._fail_wave(items, exc)
                    handle = None
                except Exception:
                    # the worker is about to die: salvage the sibling
                    # wave first (its rounds are real), and make sure no
                    # in-flight registration outlives this thread — a
                    # leaked count would wedge every other driver's
                    # planner forever
                    with self._lock:
                        self._retire_items(items)
                    if inflight is not None:
                        try:
                            self._deposit_wave(*inflight)
                        except Exception:
                            pass   # _deposit_wave retired its items
                    raise
                self._note_stragglers(stragglers_before, seq, items)

            if inflight is not None:
                try:
                    self._deposit_wave(*inflight)
                except Exception:
                    if handle is not None:
                        with self._lock:
                            self._retire_items(items)
                    raise
            inflight = ((handle, items, t0, seq) if handle is not None
                        else None)

    def _deposit_wave(self, wave: InFlightWave, items: list[WorkItem],
                      t_launch: float | None = None, seq: int = 0) -> None:
        """Host side of one pipelined wave: transfer, group-commit, and
        complete ready requests.  A transient failure relaunches the
        wave (counter addressing makes the recomputation bit-identical;
        already-folded rounds are skipped on deposit)."""
        state = {"wave": wave}

        def attempt(k: int) -> int:
            if k:
                with self._lock:
                    self.stats.restarts += 1
                self.obs.m["retries"].inc(stage="deposit")
                state["wave"] = self.batcher.launch(items)
            with self.watchdog:
                return self.batcher.deposit(state["wave"])

        stragglers_before = self.watchdog.straggler_count
        try:
            executed = run_with_policy(
                attempt, self.retry, stage="deposit", counter=seq,
                deadline=self._wave_deadline(items),
                on_retry=self._restart_hook("deposit_retry", seq, items))
        except (RetryExhausted, DeadlineExceeded) as exc:
            # permanent loss of this wave only: fail its riders and let
            # the worker keep serving everything else
            with self._lock:
                self._retire_items(items)
                self._fail_wave(items, exc)
            return
        except Exception:
            with self._lock:
                self._retire_items(items)
            raise
        self._note_stragglers(stragglers_before, seq, items)
        self.obs.m["waves"].inc()
        if t_launch is not None:
            self.obs.m["wave_seconds"].observe(
                _clock.monotonic() - t_launch)
        with self._lock:
            self._retire_items(items)
            self.stats.waves += 1
            self.stats.items_executed += executed
            self._complete_ready()
