"""Span tracing for the wave pipeline, Chrome-trace/Perfetto format.

A :class:`Tracer` turns ``with tracer.span("launch", wave=3):`` into a
complete-duration event (``ph: "X"``) and ``tracer.instant(...)`` into
an instant event (``ph: "i"``), both in the Trace Event Format that
``chrome://tracing`` and https://ui.perfetto.dev load directly.  Events
flow to pluggable sinks:

* :class:`JsonlWriter` — the on-disk artifact: one event object per
  line.  The file opens with ``[`` and each event line ends with a
  comma; the Trace Event spec makes the closing ``]`` optional, so a
  crash mid-run still leaves a loadable trace (and CI can upload it
  verbatim).  :func:`load_trace` parses one back for assertions.
* any callable ``sink(event_dict)`` — tests collect into a list.

The six pipeline stages the engine instruments are named in
:data:`STAGES`; the acceptance gate asserts a served workload's trace
covers all six.  With ``torch_annotations=True`` every span additionally
enters a ``torch.profiler.record_function`` so the same stage names line
up inside a ``torch.profiler`` trace of the card.

When tracing is off the engine holds the module-level :data:`NULL`
tracer: ``span()`` returns one shared no-op context manager, so the
disabled hot path costs two attribute lookups per stage per wave.

Timestamps come from :mod:`repro_torch.obs.clock` (monotonic ns -> trace µs)
— never from ``time`` directly.
"""

from __future__ import annotations

import json
import os
import threading

from repro_torch.obs import clock

# The wave-pipeline stages engine/batcher/store instrument, in causal
# order.  plan: the fair round-robin budget split.  launch: fused
# kernel launches, enqueued on the card's stream (they return before the
# card finishes).  device_execute: blocking on the CUDA event recorded
# after the wave's launches.  transfer: one copy of each launch's output
# to the host.  deposit: cache fold + request completion.  wal_commit:
# the group-committed journal write+fsync.
STAGES = ("plan", "launch", "device_execute", "transfer", "deposit",
          "wal_commit")


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every operation is a shared no-op."""

    enabled = False

    def span(self, name: str, **args):
        return _NULL_SPAN

    def instant(self, name: str, **args) -> None:
        return None

    def flush(self) -> None:
        return None

    def close(self) -> None:
        return None


NULL = NullTracer()


class _Span:
    __slots__ = ("tracer", "name", "args", "t0", "annotation")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.annotation = None

    def __enter__(self):
        self.t0 = clock.monotonic_ns()
        ann = self.tracer._annotation
        if ann is not None:
            self.annotation = ann(self.name)
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        t1 = clock.monotonic_ns()
        self.tracer._emit({
            "ph": "X", "name": self.name, "cat": "wave",
            "ts": self.t0 // 1000, "dur": max((t1 - self.t0) // 1000, 1),
            "pid": self.tracer.pid, "tid": threading.get_ident() & 0xFFFF,
            "args": self.args,
        })
        return False


class Tracer:
    """Emits trace events to sinks; enabled iff it has at least one."""

    enabled = True

    def __init__(self, *sinks, torch_annotations: bool = False):
        self.pid = os.getpid()
        self._sinks = list(sinks)
        self._annotation = None
        if torch_annotations:
            from torch.profiler import record_function
            self._annotation = record_function

    def add_sink(self, sink) -> None:
        self._sinks.append(sink)

    def span(self, name: str, **args) -> _Span:
        """Context manager timing one pipeline stage."""
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """A point event (failure paths: restarts, stragglers, torn
        commits) carrying stream/wave identity in ``args``."""
        self._emit({
            "ph": "i", "name": name, "cat": "event", "s": "t",
            "ts": clock.monotonic_ns() // 1000,
            "pid": self.pid, "tid": threading.get_ident() & 0xFFFF,
            "args": args,
        })

    def _emit(self, event: dict) -> None:
        for sink in self._sinks:
            sink(event)

    def flush(self) -> None:
        for sink in self._sinks:
            if hasattr(sink, "flush"):
                sink.flush()

    def close(self) -> None:
        for sink in self._sinks:
            if hasattr(sink, "close"):
                sink.close()


class JsonlWriter:
    """Trace sink writing the crash-tolerant headless-array JSONL file."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        self._f = open(self.path, "w", encoding="utf-8")
        self._f.write("[\n")
        self.n_events = 0

    def __call__(self, event: dict) -> None:
        line = json.dumps(event, sort_keys=True,
                          separators=(",", ":")) + ",\n"
        with self._lock:
            self._f.write(line)
            self.n_events += 1

    def flush(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


def load_trace(path: str) -> list[dict]:
    """Parse a :class:`JsonlWriter` artifact (or any Trace Event JSON
    array, trailing-comma/unclosed included) back into event dicts."""
    with open(path, encoding="utf-8") as f:
        text = f.read().strip()
    if text.startswith("["):
        text = text[1:]
    text = text.rstrip("]").rstrip().rstrip(",")
    if not text:
        return []
    return json.loads(f"[{text}]")


def span_totals(events: list[dict]) -> dict[str, float]:
    """Total seconds per span name over a parsed trace (``ph == "X"``).

    The host-per-wave bench phase aggregates with this; dur is µs."""
    totals: dict[str, float] = {}
    for ev in events:
        if ev.get("ph") == "X":
            totals[ev["name"]] = (totals.get(ev["name"], 0.0)
                                  + ev.get("dur", 0) / 1e6)
    return totals
