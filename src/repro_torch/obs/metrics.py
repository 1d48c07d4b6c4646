"""Process-local metrics: counters, gauges, histograms, two expositions.

A :class:`MetricsRegistry` is a flat namespace of named metrics, each
optionally split by a fixed tuple of label names (Prometheus-style:
``zmc_bucket_rounds_total{dim="3",sampler="mc"}``).  The registry is
what the engine threads through the service stack and what
``serve_integrals --metrics-port / --metrics-json`` exposes:

* :meth:`MetricsRegistry.render_prometheus` — the text exposition
  format v0.0.4 (``# TYPE`` headers, one sample per line), scrapeable
  by a real Prometheus and asserted verbatim in tests;
* :meth:`MetricsRegistry.snapshot` — a plain JSON-able dict for
  artifacts (``serve_integrals --metrics-json``).

Hot-path cost: an increment is one dict lookup (amortized: call sites
hold the child handle) plus one locked float add.  Each metric carries
its own small lock so concurrent wave drivers never lose increments —
the tests compare these counters *exactly* against the engine's own
observables (``template.launch_count``, ``RoundBatcher.fallback_rounds``),
so approximate lock-free adds are not good enough.

The canonical metric names the service exports are declared in
:func:`service_metrics` — one place, and the same names and labels as
``repro.obs.metrics.service_metrics``, so the reference's dashboards and
tests read the port unchanged.
"""

from __future__ import annotations

import threading
from typing import Iterable, Mapping

# Default histogram buckets: exponential from 1 ms to ~2 min, tuned for
# wave/stage durations (interpret-mode CPU waves sit in the 0.1-10 s
# decade; real-accelerator waves in the 1-100 ms decade).
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0)


def _label_key(labels: Mapping[str, object] | None,
               names: tuple[str, ...]) -> tuple[str, ...]:
    labels = labels or {}
    if set(labels) != set(names):
        raise ValueError(f"metric wants labels {names}, got {tuple(labels)}")
    return tuple(str(labels[n]) for n in names)


class Counter:
    """Monotone float/int accumulator, optionally labelled."""

    kind = "counter"

    def __init__(self, name: str, help_: str,
                 labelnames: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._values: dict[tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _label_key(labels, self.labelnames)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = _label_key(labels, self.labelnames)
        with self._lock:
            return self._values.get(key, 0.0)

    def _samples(self):
        with self._lock:
            items = sorted(self._values.items())
        for key, val in items:
            yield self.name, dict(zip(self.labelnames, key)), val

    def _snapshot(self):
        with self._lock:
            if not self.labelnames:
                return self._values.get((), 0.0)
            return {",".join(k): v for k, v in sorted(self._values.items())}


class Gauge(Counter):
    """A value that goes up and down (in-flight depth, pending size)."""

    kind = "gauge"

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels, self.labelnames)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def set(self, value: float, **labels) -> None:
        key = _label_key(labels, self.labelnames)
        with self._lock:
            self._values[key] = float(value)


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics), labelled."""

    kind = "histogram"

    def __init__(self, name: str, help_: str,
                 labelnames: tuple[str, ...] = (),
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(buckets))
        self._series: dict[tuple[str, ...], list] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels, self.labelnames)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                # [bucket counts..., +Inf count, sum, count]
                series = [0] * (len(self.buckets) + 1) + [0.0, 0]
                self._series[key] = series
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    series[i] += 1
                    break
            else:
                series[len(self.buckets)] += 1
            series[-2] += float(value)
            series[-1] += 1

    def count(self, **labels) -> int:
        key = _label_key(labels, self.labelnames)
        with self._lock:
            series = self._series.get(key)
            return int(series[-1]) if series else 0

    def sum(self, **labels) -> float:
        key = _label_key(labels, self.labelnames)
        with self._lock:
            series = self._series.get(key)
            return float(series[-2]) if series else 0.0

    def _samples(self):
        with self._lock:
            items = sorted((k, list(v)) for k, v in self._series.items())
        for key, series in items:
            labels = dict(zip(self.labelnames, key))
            cum = 0
            for i, edge in enumerate(self.buckets):
                cum += series[i]
                yield (f"{self.name}_bucket",
                       {**labels, "le": _fmt(edge)}, cum)
            cum += series[len(self.buckets)]
            yield f"{self.name}_bucket", {**labels, "le": "+Inf"}, cum
            yield f"{self.name}_sum", labels, series[-2]
            yield f"{self.name}_count", labels, series[-1]

    def _snapshot(self):
        with self._lock:
            items = sorted((k, list(v)) for k, v in self._series.items())
        out = {}
        for key, series in items:
            out[",".join(key)] = {
                "count": int(series[-1]), "sum": series[-2],
                "buckets": {_fmt(e): int(series[i])
                            for i, e in enumerate(self.buckets)},
                "overflow": int(series[len(self.buckets)]),
            }
        return out if self.labelnames else out.get("", {
            "count": 0, "sum": 0.0, "buckets": {}, "overflow": 0})


def _fmt(x: float) -> str:
    return f"{x:g}"


class MetricsRegistry:
    """Named metrics + the two expositions (Prometheus text, JSON)."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "",
                labelnames: tuple[str, ...] = ()) -> Counter:
        return self._get_or_make(Counter, name, help_, labelnames)

    def gauge(self, name: str, help_: str = "",
              labelnames: tuple[str, ...] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help_, labelnames)

    def histogram(self, name: str, help_: str = "",
                  labelnames: tuple[str, ...] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = Histogram(name, help_, labelnames, buckets)
                self._metrics[name] = metric
        if not isinstance(metric, Histogram):
            raise TypeError(f"{name} already registered as {metric.kind}")
        return metric

    def _get_or_make(self, cls, name, help_, labelnames):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = cls(name, help_, labelnames)
                self._metrics[name] = metric
        if type(metric) is not cls:
            raise TypeError(f"{name} already registered as {metric.kind}")
        if metric.labelnames != tuple(labelnames):
            raise ValueError(
                f"{name} registered with labels {metric.labelnames}, "
                f"asked for {tuple(labelnames)}")
        return metric

    def get(self, name: str):
        return self._metrics.get(name)

    def render_prometheus(self) -> str:
        """Text exposition format v0.0.4."""
        lines = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, metric in metrics:
            if metric.help:
                lines.append(f"# HELP {name} {metric.help}")
            lines.append(f"# TYPE {name} {metric.kind}")
            for sample, labels, value in metric._samples():
                if labels:
                    inner = ",".join(f'{k}="{v}"'
                                     for k, v in labels.items())
                    lines.append(f"{sample}{{{inner}}} {_fmt_val(value)}")
                else:
                    lines.append(f"{sample} {_fmt_val(value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able view: ``{name: {"type", "value"}}``."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        return {name: {"type": m.kind, "value": m._snapshot()}
                for name, m in metrics}


def _fmt_val(value: float) -> str:
    as_int = int(value)
    return str(as_int) if value == as_int else repr(float(value))


def service_metrics(registry: MetricsRegistry) -> dict:
    """Declare (idempotently) every metric the service stack exports.

    One place for the canonical names (the reference package's):

    ==============================  =============================================
    zmc_kernel_launches_total        fused kernel launches (= template counter)
    zmc_fallback_rounds_total        rounds on the chunked path (= batcher obs)
    zmc_cache_requests_total         {outcome=hit|miss} request-level cache fate
    zmc_warm_zero_launch_total       requests served entirely from cache
    zmc_requests_submitted_total     submit() calls accepted
    zmc_requests_served_total        results finalized
    zmc_waves_total                  engine waves deposited
    zmc_wave_restarts_total          run_with_restarts retries
    zmc_straggler_events_total       StepWatchdog threshold trips
    zmc_deposit_rounds_total         rounds folded into the cache
    zmc_inflight_rounds              gauge: rounds dispatched, not yet deposited
    zmc_pending_requests             gauge: requests parked in the pending table
    zmc_wave_seconds                 histogram: end-to-end wave wall time
    zmc_stage_seconds                histogram {stage}: per-pipeline-stage time
    zmc_wave_rounds                  histogram {sampler}: rounds per fused launch
    zmc_bucket_rounds_total          {dim,sampler}: rounds per bucket signature
    zmc_wal_bytes_total              journal bytes written
    zmc_wal_fsync_seconds            histogram: fsync+write latency per commit
    zmc_wal_commits_total            journal write batches
    zmc_sweep_requests_total         sweep requests accepted
    zmc_sweep_points_total           grid points across accepted sweeps
    zmc_sweep_slices_total           {outcome=new|shared}: canonical sweep
                                     slices allocated vs deduped onto an
                                     existing cache stream
    zmc_faults_injected_total        {stage}: chaos-harness faults fired
                                     (agrees with FaultPlan.fired)
    zmc_retries_total                {stage}: retry attempts the unified
                                     policy actually ran (agrees with
                                     EngineStats.restarts)
    zmc_quarantined_streams_total    streams quarantined by the poison
                                     ladder (agrees with
                                     ResultCache.quarantined_streams)
    zmc_deadline_expirations_total   tickets failed on an expired deadline
    zmc_adapted_streams_total        importance-grid epoch streams opened
                                     (one per VEGAS grid fit, incl. epoch 1)
    zmc_grid_refits_total            grid refits (epoch openings beyond the
                                     first; agrees with ``grid_refit`` trace
                                     events)
    ==============================  =============================================
    """
    return {
        "launches": registry.counter(
            "zmc_kernel_launches_total",
            "fused kernel launches (agrees with "
            "repro_torch.kernels.template.launch_count)"),
        "fallback_rounds": registry.counter(
            "zmc_fallback_rounds_total",
            "rounds served by the chunked per-round path (agrees with "
            "RoundBatcher.fallback_rounds)"),
        "cache_requests": registry.counter(
            "zmc_cache_requests_total",
            "request-level cache outcomes", ("outcome",)),
        "warm_zero_launch": registry.counter(
            "zmc_warm_zero_launch_total",
            "requests served entirely from cache (zero launches)"),
        "submitted": registry.counter(
            "zmc_requests_submitted_total", "accepted submit() calls"),
        "served": registry.counter(
            "zmc_requests_served_total", "finalized results"),
        "waves": registry.counter(
            "zmc_waves_total", "engine waves deposited"),
        "restarts": registry.counter(
            "zmc_wave_restarts_total",
            "wave attempts retried by run_with_restarts"),
        "stragglers": registry.counter(
            "zmc_straggler_events_total",
            "StepWatchdog threshold trips"),
        "deposit_rounds": registry.counter(
            "zmc_deposit_rounds_total", "rounds folded into the cache"),
        "inflight": registry.gauge(
            "zmc_inflight_rounds",
            "rounds dispatched but not yet deposited (wave depth)"),
        "pending": registry.gauge(
            "zmc_pending_requests", "requests parked in the pending table"),
        "wave_seconds": registry.histogram(
            "zmc_wave_seconds", "end-to-end wave wall time"),
        "stage_seconds": registry.histogram(
            "zmc_stage_seconds",
            "wall time per wave-pipeline stage", ("stage",)),
        "wave_rounds": registry.histogram(
            "zmc_wave_rounds", "rounds per fused launch group", ("sampler",),
            buckets=(1, 2, 4, 8, 16, 32, 64)),
        "bucket_rounds": registry.counter(
            "zmc_bucket_rounds_total",
            "rounds evaluated per (dim, sampler) bucket signature",
            ("dim", "sampler")),
        "wal_bytes": registry.counter(
            "zmc_wal_bytes_total", "journal bytes written"),
        "wal_fsync_seconds": registry.histogram(
            "zmc_wal_fsync_seconds",
            "write+fsync latency per journal commit"),
        "wal_commits": registry.counter(
            "zmc_wal_commits_total", "journal write batches"),
        "sweep_submitted": registry.counter(
            "zmc_sweep_requests_total", "accepted sweep requests"),
        "sweep_points": registry.counter(
            "zmc_sweep_points_total",
            "grid points across accepted sweep requests"),
        "sweep_slices": registry.counter(
            "zmc_sweep_slices_total",
            "canonical sweep slices by cache fate (shared = deduped onto "
            "an existing stream, incl. sub-grid overlap with another "
            "client's sweep)", ("outcome",)),
        "faults_injected": registry.counter(
            "zmc_faults_injected_total",
            "deterministic chaos faults fired (agrees with "
            "FaultPlan.fired)", ("stage",)),
        "retries": registry.counter(
            "zmc_retries_total",
            "retry attempts run by the unified policy (agrees with "
            "EngineStats.restarts across stages)", ("stage",)),
        "quarantined_streams": registry.counter(
            "zmc_quarantined_streams_total",
            "streams quarantined by the poison ladder (agrees with "
            "ResultCache.quarantined_streams)"),
        "deadline_expirations": registry.counter(
            "zmc_deadline_expirations_total",
            "tickets completed as RequestFailed on an expired deadline"),
        "adapted_streams": registry.counter(
            "zmc_adapted_streams_total",
            "importance-grid epoch streams opened (one per VEGAS grid "
            "fit, including the first epoch)"),
        "grid_refits": registry.counter(
            "zmc_grid_refits_total",
            "importance-grid refits (epoch openings beyond the first)"),
    }
