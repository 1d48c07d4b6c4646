"""Cross-request coalescing into fused multi-round dimension buckets
(port of ``repro.service.batcher``).

The unit of work in the service is a **(canonical family, round)** pair:
``round_samples`` samples of one cached stream, addressed purely by
counters (key, fn_offset, round * round_samples).  This module takes the
set of work items one engine wave produced — typically spanning many
client requests at different cache fill levels — and evaluates them in
as few kernel launches as possible:

* per (stream, sampler) the wave's rounds form one contiguous **span**
  ``[start, start + count)`` rooted at the stream's fold frontier;
* spans are grouped by ``(sampler, count)`` and each group's families go
  to the fused multi-round planner (:mod:`repro_torch.kernels.mc_eval.multi`),
  which buckets them by integrand dimension and evaluates ALL ``count``
  rounds of a bucket in ONE kernel launch (``launch_plan_rounds``): an
  R-round wave over B buckets costs B launches, not R x B.  Spans may
  start at different stream depths (per-function-block ``round_base``
  window starts carry each stream's offset);
* families whose form is not fusable fall back to the chunked path, one
  round at a time (still counter-addressed, still cacheable).

Evaluation is split into :meth:`RoundBatcher.launch` and
:meth:`RoundBatcher.deposit`.  ``launch`` enqueues the wave's kernels on
the card's current stream, then one asynchronous copy of each launch's
``[R, F, 2]`` output into pinned host memory, and records a CUDA event
behind them; it returns before the card has finished.  ``deposit`` waits
on that event only (``device_execute``: not a whole-device synchronise,
which would also wait for the next wave the engine has already
launched), slices the host copies in numpy (``transfer``), and
group-commits one cache fold per wave (``deposit``).  The engine
pipelines the two: wave k+1's launch overlaps wave k's transfer and
deposit.  :meth:`RoundBatcher.execute` composes them for synchronous
drivers.

Deposits stay **side-effect free until the end of the wave** and are
folded in round order per entry.  Rounds the cache already folded are
skipped (a replayed or racing wave recomputes bit-identical sums), so a
crash-and-restart of a wave and concurrent ``step()`` drivers are both
safe.

Fusion plans (the packed/concatenated bucket operands) are cached per
(entry set, sampler) with **LRU eviction** — steady-state request mixes
keep their plans instead of re-planning everything.

On a mesh the fused waves go through ``multi.sharded_eval_plan_rounds``
and the chunked rounds through ``direct_mc.sharded_family_sums``; the sum
across ranks happens inside the launch, as ``repro``'s ``psum`` sits
inside its ``shard_map``, so every rank deposits the same bits.  Every
rank must launch the same waves in the same order (the engine's lockstep
rule).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import numpy as np

import torch

from repro_torch.analysis import streams as _analysis
from repro_torch.core import direct_mc
from repro_torch.core.direct_mc import SumsState
from repro_torch.core.integrand import MultiFunctionSpec
from repro_torch.service.cache import CacheEntry, ResultCache
from repro_torch.service.faults import NULL_FAULTS


@dataclasses.dataclass(frozen=True)
class WorkItem:
    """One round of one cached stream."""
    chash: str
    round_index: int
    sampler: str


@dataclasses.dataclass(frozen=True)
class _Span:
    """One stream's contiguous slice of a wave: rounds [start, start+count)."""
    entry: CacheEntry
    sampler: str
    start: int
    count: int


@dataclasses.dataclass
class InFlightWave:
    """A dispatched wave whose sums may still be computing on the card.

    ``results`` holds ``(entry, round_index, src)`` with each entry's
    rounds ascending; ``src`` is ``(output, round, row_start, n_fn)``
    into ``host`` for a fused round, or a SumsState of host tensors for a
    chunked one.  ``host`` holds the launches' outputs as they are being
    copied to the host; ``done`` is the CUDA event recorded behind all
    the wave's copies, fused and chunked (None when the wave ran on the
    CPU).
    """
    results: list[tuple[CacheEntry, int, object]]
    n_items: int
    host: list[torch.Tensor] = dataclasses.field(default_factory=list)
    done: object = None


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Asynchronous copy to (pinned) host memory; a no-op on the CPU."""
    return t.to("cpu", non_blocking=True) if t.device.type == "cuda" else t


class RoundBatcher:
    """Coalesces work items into fused multi-round launches, one RNG key."""

    def __init__(self, cache: ResultCache, key, *, use_kernel: bool = True,
                 mesh=None, fn_axis: str = "model", sample_axes=("data",),
                 chunk: int = 8192, plan_cache_size: int = 256,
                 obs=None, faults=None):
        if obs is None:
            from repro_torch.obs import Observability
            obs = Observability.disabled()
        self.obs = obs
        self.faults = NULL_FAULTS if faults is None else faults
        self.cache = cache
        self.key = key
        self.use_kernel = bool(use_kernel)
        self.mesh = mesh
        self.fn_axis = fn_axis
        self.sample_axes = tuple(sample_axes)
        self.chunk = int(chunk)
        self.plan_cache_size = int(plan_cache_size)
        # rounds served by the chunked per-round path instead of a fused
        # launch: 0 for registered-form workloads (compactified families
        # included)
        self.fallback_rounds = 0
        self._plans: collections.OrderedDict[tuple, object] = \
            collections.OrderedDict()

    # -- wave evaluation ------------------------------------------------------
    def execute(self, items: Sequence[WorkItem]) -> int:
        """Launch + deposit one wave synchronously; returns items executed."""
        return self.deposit(self.launch(items))

    def launch(self, items: Sequence[WorkItem]) -> InFlightWave:
        """Dispatch all items to the device; no cache side effects.

        Items are deduplicated (two requests wanting the same round of
        the same stream cost one evaluation), folded into per-stream
        contiguous spans, and spans sharing a round count are evaluated
        by one fused multi-round launch per dimension bucket.
        """
        obs = self.obs
        unique = sorted(set(items),
                        key=lambda it: (it.sampler, it.chash, it.round_index))
        groups: dict[tuple[str, int], list[_Span]] = {}
        for span in self._spans_of(unique):
            groups.setdefault((span.sampler, span.count), []).append(span)

        from repro_torch.kernels import template
        launches_before = template.launch_count()
        wave = InFlightWave(results=[], n_items=len(unique))
        with obs.span("launch", items=len(unique), groups=len(groups)):
            self.faults.check("launch")
            for group_key in sorted(groups):
                self._launch_group(groups[group_key], wave)
            # one event behind every copy of the wave, fused outputs and
            # chunked sums alike, so deposit never reads an unfilled buffer
            chunked = [src for _, _, src in wave.results
                       if isinstance(src, SumsState)]
            cuda = [t.device for t in wave.host if t.device.type == "cuda"]
            cuda += [s.s1.device for s in chunked
                     if s.s1.device.type == "cuda"]
            wave.host = [_to_host(t) for t in wave.host]
            wave.results = [
                (entry, ri, SumsState(s1=_to_host(src.s1),
                                      s2=_to_host(src.s2), n=src.n))
                if isinstance(src, SumsState) else (entry, ri, src)
                for entry, ri, src in wave.results]
            if cuda:
                wave.done = torch.cuda.Event()
                wave.done.record(torch.cuda.current_stream(cuda[0]))
        obs.m["launches"].inc(template.launch_count() - launches_before)
        return wave

    def deposit(self, wave: InFlightWave) -> int:
        """Materialize a launched wave and group-commit it to the cache.

        Waits on the wave's CUDA event (wave k's transfer overlaps wave
        k+1's launches when the engine pipelines), then folds every round
        through :meth:`ResultCache.deposit_wave` — one WAL fsync for the
        whole wave.  Returns the wave's item count.
        """
        obs = self.obs
        if _analysis.asserts_enabled():
            # STR002 live: no double-deposits or gaps within the wave
            per_stream: dict[str, list[int]] = {}
            for entry, round_index, _ in wave.results:
                per_stream.setdefault(entry.chash[:16],
                                      []).append(round_index)
            _analysis.assert_wave_consistent(per_stream)
        if wave.results:
            with obs.span("device_execute", items=wave.n_items):
                # wait for this wave's launches and copies only, before
                # converting, so the trace splits device wait from
                # host-side transfer
                self.faults.check("device_execute")
                if wave.done is not None:
                    wave.done.synchronize()
        with obs.span("transfer", items=wave.n_items):
            self.faults.check("transfer")
            host = [t.numpy() for t in wave.host]
            deposits = []
            for entry, round_index, src in wave.results:
                if isinstance(src, SumsState):
                    s1, s2 = src.s1.numpy(), src.s2.numpy()
                    n = np.float32(src.n)
                else:
                    out, r, row, n_fn = src
                    s1 = host[out][r, row:row + n_fn, 0]
                    s2 = host[out][r, row:row + n_fn, 1]
                    n = np.float32(self.cache.round_samples)
                deposits.append((entry, round_index, SumsState(
                    s1=np.asarray(s1, np.float32),
                    s2=np.asarray(s2, np.float32), n=n)))
            if (self.faults.enabled and deposits
                    and self.faults.fire("transfer_nan")):
                # poison the wave's first deposit: the cache's finite
                # check must reject it pre-journal and strike its stream
                entry, ri, sums = deposits[0]
                deposits[0] = (entry, ri, SumsState(
                    s1=np.full_like(sums.s1, np.nan),
                    s2=sums.s2, n=sums.n))
        with obs.span("deposit", items=wave.n_items):
            self.faults.check("deposit")
            self.cache.deposit_wave(deposits)
        return wave.n_items

    # -- wave shaping ---------------------------------------------------------
    def _spans_of(self, unique: Sequence[WorkItem]) -> list[_Span]:
        by_stream: dict[tuple[str, str], list[int]] = {}
        for it in unique:
            by_stream.setdefault((it.chash, it.sampler),
                                 []).append(it.round_index)
        spans = []
        for (chash, sampler) in sorted(by_stream):
            entry = self.cache.get(chash)
            if entry is None:
                raise KeyError(f"work item for unknown entry {chash}")
            rounds = sorted(by_stream[(chash, sampler)])
            if rounds != list(range(rounds[0], rounds[0] + len(rounds))):
                raise ValueError(
                    f"non-contiguous rounds {rounds} for stream "
                    f"{chash[:16]}: the planner must emit gap-free spans")
            spans.append(_Span(entry=entry, sampler=sampler,
                               start=rounds[0], count=len(rounds)))
        return spans

    def _launch_group(self, spans: list[_Span], wave: InFlightWave) -> None:
        """One fused multi-round evaluation of same-count spans, appended
        to ``wave``."""
        n = self.cache.round_samples
        count = spans[0].count
        sampler = spans[0].sampler
        self.obs.m["wave_rounds"].observe(count, sampler=sampler)
        for sp in spans:
            self.obs.m["bucket_rounds"].inc(
                count, dim=sp.entry.family.dim, sampler=sampler)
        # streams the poison ladder degraded leave the fused path: they
        # re-run on the chunked per-round fallback, isolated from the
        # healthy buckets they shared a launch with (counter addressing
        # keeps the chunked recomputation bit-identical to the fused one)
        healthy = [sp for sp in spans if not sp.entry.degraded]
        degraded = [sp for sp in spans if sp.entry.degraded]

        where: dict[int, tuple[int, int, int]] = {}
        if self.use_kernel and healthy:
            entries = [sp.entry for sp in healthy]
            fn_offsets = [e.fn_offset for e in entries]
            spec = MultiFunctionSpec(
                families=tuple(e.family for e in entries))
            from repro_torch.kernels.mc_eval import multi
            self.faults.check("device_error")
            plan = self._plan_for(entries, sampler, spec, fn_offsets)
            start_rounds = {i: sp.start for i, sp in enumerate(healthy)}
            if self.mesh is None:
                where, outputs = multi.launch_plan_rounds(
                    plan, n, count, self.key, start_rounds=start_rounds)
            else:
                where, outputs = multi.sharded_eval_plan_rounds(
                    plan, n, count, self.key, self.mesh,
                    start_rounds=start_rounds, fn_axis=self.fn_axis,
                    sample_axes=self.sample_axes)
            first = len(wave.host)
            wave.host.extend(outputs)
            where = {i: (first + b, row, n_fn)
                     for i, (b, row, n_fn) in where.items()}

        for idx, sp in enumerate(healthy):
            if idx in where:
                out, row, n_fn = where[idx]
                wave.results.extend((sp.entry, sp.start + r, (out, r, row, n_fn))
                                    for r in range(count))
                continue
            wave.results.extend(self._chunked_rounds(sp, count, n, sampler))
        for sp in degraded:
            wave.results.extend(self._chunked_rounds(sp, count, n, sampler))

    def _chunked_rounds(self, sp: _Span, count: int, n: int, sampler: str):
        """Chunked fallback: one counter-addressed eval per round, its
        sums left where they were computed (``launch`` copies them)."""
        self.fallback_rounds += count
        self.obs.m["fallback_rounds"].inc(count)
        out = []
        for r in range(count):
            kw = dict(fn_offset=sp.entry.fn_offset,
                      sample_offset=(sp.start + r) * n, chunk=self.chunk,
                      use_kernel=self.use_kernel, sampler=sampler)
            if self.mesh is None:
                sums = direct_mc.family_sums(sp.entry.family, n, self.key, **kw)
            else:
                sums, _ = direct_mc.sharded_family_sums(
                    sp.entry.family, n, self.key, self.mesh,
                    fn_axis=self.fn_axis, sample_axes=self.sample_axes, **kw)
                sums = SumsState(s1=sums.s1[:sp.entry.n_fn],
                                 s2=sums.s2[:sp.entry.n_fn], n=sums.n)
            out.append((sp.entry, sp.start + r, SumsState(
                s1=sums.s1, s2=sums.s2, n=n)))
        return out

    def _plan_for(self, entries: list[CacheEntry], sampler: str, spec,
                  fn_offsets):
        """LRU-cached fusion plan for this exact entry set.

        The plan holds packed per-entry operands, so the cache key is the
        entry identity tuple; eviction is least-recently-used (a full
        cache drops only the coldest mix, never the working set).
        """
        from repro_torch.kernels.mc_eval import multi
        plan_key = (tuple(e.chash for e in entries), sampler)
        plan = self._plans.get(plan_key)
        if plan is not None:
            self._plans.move_to_end(plan_key)
            return plan
        plan = multi.plan_spec(spec, sampler=sampler, fn_offsets=fn_offsets)
        self._plans[plan_key] = plan
        while len(self._plans) > self.plan_cache_size:
            self._plans.popitem(last=False)
        return plan
