"""Integration-as-a-service launcher (port of
``repro.launch.serve_integrals``).

``python -m repro_torch.launch.serve_integrals --requests 64`` stands up
the continuously-batching
:class:`~repro_torch.service.engine.IntegrationEngine` on the card, feeds
it a mixed-dimension workload (seven families at dims 2-4, every fourth
request a verbatim re-ask), and reports throughput, launch counts and
cache behavior.  ``--thread`` runs the async submit/poll worker; the
default drives waves synchronously.  ``--device cpu`` runs the kernels'
plain PyTorch versions on the CPU; ``--no-kernel`` takes the chunked
path instead of the fused kernel.

Each wave fuses its rounds into multi-round kernels — an R-round wave
over B dimension buckets costs B launches — and with ``--thread`` the
worker double-buffers waves (wave k+1's kernels run while wave k's
results transfer, deposit and group-commit to the WAL; ``--no-pipeline``
serializes them).  ``--max-rounds-per-wave`` caps rounds per stream per
wave (the fused kernel's R); ``--max-items-per-wave`` bounds the whole
wave, assigned round-robin across requests.

``--state-dir PATH`` journals every round deposit (crash-safe,
checksummed, the reference package's format) and snapshots on clean
shutdown; re-launching against the same dir resumes every cached stream
bit-identically, serving already-satisfied requests with zero launches.
``--compact-on-start`` folds the replayed journal into one snapshot
first.

Telemetry (:mod:`repro_torch.obs`): ``--trace-out trace.json`` records a
span per pipeline stage (plan / launch / device_execute / transfer /
deposit / wal_commit) in Chrome-trace format; ``--torch-trace`` also
wraps each span in ``torch.profiler.record_function``;
``--metrics-port P`` serves Prometheus text at
``http://127.0.0.1:P/metrics``; ``--metrics-json PATH`` writes a final
metrics + convergence snapshot.

``--mesh`` serves on every rank of a mesh (as ``integrate --mesh``:
torchrun's processes, or ``--ranks`` started here; ``--backend gloo`` for
ranks that share a card).  The ranks work in lockstep: each submits the
same workload in the same order, with ``--thread`` before its worker
starts.  Rank 0 prints.

Sweep requests ride the library entry point, ``demo_workload(sweeps=k)``,
as in the reference launcher, which has no flag for them either.  Not
ported yet: ``--audit-state`` (queue 1 item 2); the reference's auditor
reads the port's state dirs as they are (``python -m repro.analysis
--state-dir DIR``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch.distributed as dist

from repro_torch.core import genz
from repro_torch.core.integrand import (abs_sum_family, gaussian_family,
                                        harmonic_family)
from repro_torch.launch import multihost
from repro_torch.obs import clock as _clock
from repro_torch.service.api import IntegrationRequest, SweepRequest


def demo_workload(n_requests: int, *, n_fn: int = 8,
                  n_samples: int | None = 16384,
                  target_stderr: float | None = None,
                  duplicate_every: int = 4,
                  sweeps: int = 0) -> list:
    """A mixed-dimension request stream with deliberate overlap.

    Cycles through the registered forms at dims 2-4 (so batching has
    buckets to fuse) plus Gaussians over R^d and the positive orthant
    (compactified families, fused like the finite ones), and re-issues
    every ``duplicate_every``-th request verbatim (distinct clients with
    overlapping asks, which the canonicalizer dedupes).  With
    ``sweeps=k`` it appends ``k`` sweep requests (:class:`SweepRequest`),
    each a harmonic template scanned over a 2-D (a, b) grid, consecutive grids
    extending the slowest axis so their canonical slices overlap.  The
    requests are those of ``repro.launch.serve_integrals.demo_workload``,
    with the same parameters.
    """
    reqs: list = []
    makers = [
        lambda i: harmonic_family(n_fn, 2 + i % 3),
        lambda i: abs_sum_family(n_fn, 2 + i % 3,
                                 np.linspace(0.5, 2.0, n_fn)),
        lambda i: gaussian_family(n_fn, 2 + i % 3),
        lambda i: genz.oscillatory(n_fn, 2 + i % 3, seed=i % 5)[0],
        lambda i: genz.corner_peak(n_fn, 2 + i % 3, seed=i % 5)[0],
        lambda i: gaussian_family(n_fn, 2 + i % 3, lo=-np.inf, hi=np.inf),
        lambda i: gaussian_family(n_fn, 2 + i % 3, lo=0.0, hi=np.inf),
    ]
    for i in range(n_requests):
        if duplicate_every and i % duplicate_every == duplicate_every - 1:
            # verbatim re-ask of an earlier request (different client)
            fams = reqs[i // 2].families
        else:
            fams = (makers[i % len(makers)](i),)
        reqs.append(IntegrationRequest.make(
            fams, n_samples=n_samples, target_stderr=target_stderr))
    for j in range(sweeps):
        # consecutive sweeps extend the slowest-varying axis, so their
        # canonical slice prefixes align and dedupe at the cache
        grid = {"a": np.linspace(0.5, 2.0, 4 + 2 * j),
                "b": np.linspace(-1.0, 1.0, 8)}
        reqs.append(SweepRequest.make(
            harmonic_family(1, 2 + j % 3), grid,
            n_samples=n_samples, target_stderr=target_stderr))
    return reqs


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--n-fn", type=int, default=8,
                    help="functions per requested family")
    ap.add_argument("--samples", type=int, default=16384)
    ap.add_argument("--target-stderr", type=float, default=None,
                    help="serve to precision instead of a fixed budget")
    ap.add_argument("--round-samples", type=int, default=8192)
    ap.add_argument("--max-rounds-per-wave", type=int, default=8,
                    help="rounds per stream per wave — the R of each "
                         "fused multi-round launch")
    ap.add_argument("--max-items-per-wave", type=int, default=None,
                    help="total round budget per wave, assigned "
                         "round-robin across pending requests (fairness "
                         "under load); default unbounded")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="serialize waves instead of double-buffering "
                         "dispatch against host deposits (--thread mode)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--no-kernel", action="store_true",
                    help="chunked PyTorch path instead of the fused kernel")
    multihost.add_mesh_args(ap)
    ap.add_argument("--thread", action="store_true",
                    help="run the async worker thread (submit/poll mode)")
    ap.add_argument("--state-dir", default=None,
                    help="persist the cache here (journal + snapshots); "
                         "re-launching against it warm-starts every stream")
    ap.add_argument("--compact-on-start", action="store_true",
                    help="fold the replayed journal into one npz snapshot "
                         "before serving")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto span timeline of "
                         "every wave-pipeline stage here")
    ap.add_argument("--torch-trace", action="store_true",
                    help="wrap pipeline spans in torch.profiler "
                         "record_function annotations")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus metrics on this port while the "
                         "workload runs (/metrics, /metrics.json, "
                         "/convergence); 0 picks a free port")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write a final metrics + convergence snapshot "
                         "here on exit")
    return ap


def main(argv=None) -> dict:
    """Serve the demo workload; returns a summary (the results, the
    engine's stats and counts) for callers that check it."""
    args = build_parser().parse_args(argv)
    if args.mesh and not multihost.initialize_if_needed(
            verbose=False, device=args.device, backend=args.backend):
        return multihost.spawn_launcher(main, args,
                                        sys.argv[1:] if argv is None else argv)

    from repro_torch.kernels import template
    from repro_torch.launch.mesh import launcher_mesh, mesh_info
    from repro_torch.service import IntegrationEngine

    mesh = launcher_mesh(args.device) if args.mesh else None
    # rank 0 speaks for the lockstepped ranks
    say = print if mesh is None or dist.get_rank() == 0 else (lambda *a, **k: None)

    telemetry = (args.trace_out is not None or args.torch_trace
                 or args.metrics_port is not None
                 or args.metrics_json is not None)
    obs = None
    metrics_server = None
    if telemetry:
        from repro_torch.obs import Observability
        obs = Observability.enabled(trace_path=args.trace_out,
                                    torch_annotations=args.torch_trace)
        if args.metrics_port is not None:
            from repro_torch.obs.export import MetricsServer
            metrics_server = MetricsServer(obs.metrics,
                                           port=args.metrics_port,
                                           convergence=obs.convergence)
            say(f"metrics: http://127.0.0.1:{metrics_server.port}/metrics")

    engine = IntegrationEngine(
        seed=args.seed, round_samples=args.round_samples,
        use_kernel=not args.no_kernel, device=args.device, mesh=mesh,
        max_rounds_per_wave=args.max_rounds_per_wave,
        max_items_per_wave=args.max_items_per_wave,
        pipeline_waves=not args.no_pipeline,
        state_dir=args.state_dir, compact_on_start=args.compact_on_start,
        obs=obs)
    if engine.cache.recovered is not None:
        rec = engine.cache.recovered
        say(f"warm start: {len(rec.entries)} persisted streams "
            f"({rec.journal_records} journal records replayed, "
            f"{rec.truncated_bytes} corrupt tail bytes truncated)")
    reqs = demo_workload(
        args.requests, n_fn=args.n_fn,
        n_samples=None if args.target_stderr else args.samples,
        target_stderr=args.target_stderr)

    template.reset_launch_count()
    t0 = _clock.monotonic()
    try:
        if args.thread:
            if mesh is None:
                engine.start()
                tickets = [engine.submit(r) for r in reqs]
            else:
                # lockstep: every rank's worker sees the whole workload at
                # its first wave, so all plan the same waves
                tickets = [engine.submit(r) for r in reqs]
                engine.start()
            results = [engine.result(t, timeout=600.0) for t in tickets]
            engine.stop()
        else:
            tickets = [engine.submit(r) for r in reqs]
            while engine.step():
                pass
            results = [engine.poll(t) for t in tickets]
        dt = _clock.monotonic() - t0
        launches = template.launch_count()
    finally:
        engine.close()   # snapshot-on-shutdown when --state-dir is set

    n_fn_total = sum(r.n_fn_total for r in results)
    hits = sum(r.served_from_cache for r in results)
    where = engine.device if mesh is None else mesh_info(mesh)["shape"]
    say(f"served {len(results)} requests ({n_fn_total} integrands) "
        f"on {where} in {dt:.1f}s -> {len(results) / dt:.1f} "
        f"req/s, {launches} kernel launches "
        f"({engine.batcher.fallback_rounds} chunked fallback rounds), "
        f"{hits} pure cache hits")
    say(f"engine: {engine.stats}")
    say(f"cache:  {engine.cache.stats()}")
    say(f"stragglers: {engine.watchdog.straggler_count}")
    worst = max(float(r.stderrs.max()) for r in results)
    say(f"worst stderr served: {worst:.3e}")
    if args.state_dir:
        say(f"state snapshotted to {args.state_dir} "
            f"(journal compacted to {engine.store.journal_size()} bytes)")

    if obs is not None:
        streams = obs.convergence.streams()
        if streams:
            say(f"convergence: {len(streams)} streams tracked; "
                "final stderr per stream:")
            for sid in streams:
                last = obs.convergence.trajectory(sid)[-1]
                say(f"  {sid[:16]}  rounds={last.rounds_done:4d} "
                    f"n={last.n:9d}  stderr_max={last.stderr_max:.3e}")
        if args.metrics_json:
            from repro_torch.obs.export import write_snapshot
            write_snapshot(args.metrics_json, obs.metrics,
                           convergence=obs.convergence)
            say(f"metrics snapshot written to {args.metrics_json}")
        if metrics_server is not None:
            metrics_server.close()
        obs.close()
        if args.trace_out:
            say(f"trace written to {args.trace_out} "
                "(open in https://ui.perfetto.dev)")
    return {"results": results, "seconds": dt, "launches": launches,
            "fallback_rounds": engine.batcher.fallback_rounds,
            "hits": hits, "stats": engine.stats, "device": engine.device}


if __name__ == "__main__":
    main()
