"""Telemetry for the integration service: tracing, metrics, convergence.

One :class:`Observability` object threads through the whole service
stack (engine -> batcher -> cache -> store) and bundles the four
telemetry channels:

* ``tracer``       — wave-pipeline span/instant events
  (:mod:`repro_torch.obs.trace`, Chrome-trace/Perfetto JSONL);
* ``metrics``      — the counter/gauge/histogram registry with
  Prometheus text + JSON expositions (:mod:`repro_torch.obs.metrics`);
* ``convergence``  — per-stream stderr-vs-rounds trajectories
  (:mod:`repro_torch.obs.convergence`);
* ``clock``        — the single wall-clock shim every service-layer
  timestamp goes through (:mod:`repro_torch.obs.clock`).

``Observability.disabled()`` (the engine default) carries the null
tracer and skips convergence recording; metric objects still exist so
call sites never branch, and the whole disabled path costs a few dict
lookups and locked adds per *wave*.

Construction is cheap and side-effect free; sinks (trace file, metrics
port) attach at the edges (``serve_integrals`` flags).
"""

from __future__ import annotations

from repro_torch.obs import clock
from repro_torch.obs.convergence import ConvergenceLog, TrajectoryPoint
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               service_metrics)
from repro_torch.obs.trace import (STAGES, JsonlWriter, NullTracer, Tracer,
                             load_trace, span_totals)

__all__ = [
    "Observability", "ConvergenceLog", "TrajectoryPoint",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "service_metrics",
    "STAGES", "JsonlWriter", "NullTracer", "Tracer", "load_trace",
    "span_totals", "clock",
]


class Observability:
    """The telemetry bundle the engine threads through the stack."""

    def __init__(self, *, tracer=None, metrics: MetricsRegistry | None = None,
                 convergence: ConvergenceLog | None = None,
                 record_convergence: bool = True):
        from repro_torch.obs.trace import NULL
        self.tracer = tracer if tracer is not None else NULL
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.convergence = (convergence if convergence is not None
                            else ConvergenceLog())
        self.record_convergence = bool(record_convergence)
        # the canonical service metric handles, pre-resolved so hot
        # paths never pay the registry lookup
        self.m = service_metrics(self.metrics)
        if self.tracer.enabled:
            # spans already time the stages; mirror their durations into
            # the per-stage latency histogram so the Prometheus
            # exposition and the trace artifact can never disagree
            stage_hist = self.m["stage_seconds"]

            def _stage_sink(ev: dict) -> None:
                if ev.get("ph") == "X" and ev["name"] in STAGES:
                    stage_hist.observe(ev["dur"] / 1e6, stage=ev["name"])

            self.tracer.add_sink(_stage_sink)

    @classmethod
    def disabled(cls) -> "Observability":
        """The default: null tracer, no convergence recording, metrics
        still counted (they are the service's own observables)."""
        return cls(record_convergence=False)

    @classmethod
    def enabled(cls, *, trace_path: str | None = None,
                torch_annotations: bool = False,
                sinks=(), max_trajectory_points: int = 512
                ) -> "Observability":
        """Full telemetry: tracing (to ``trace_path`` and/or extra
        ``sinks``), metrics, convergence accounting."""
        all_sinks = list(sinks)
        if trace_path is not None:
            all_sinks.append(JsonlWriter(trace_path))
        tracer = Tracer(*all_sinks, torch_annotations=torch_annotations)
        return cls(tracer=tracer,
                   convergence=ConvergenceLog(max_trajectory_points),
                   record_convergence=True)

    @property
    def tracing(self) -> bool:
        return self.tracer.enabled

    def span(self, name: str, **args):
        return self.tracer.span(name, **args)

    def event(self, name: str, **args) -> None:
        self.tracer.instant(name, **args)

    def close(self) -> None:
        self.tracer.close()
