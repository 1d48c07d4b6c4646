"""Service quickstart on the PyTorch port: integrals as requests against a
caching engine (``examples/service_quickstart.py``'s counterpart on
``repro_torch``).

    PYTHONPATH=src python examples/service_quickstart_torch.py [--device cpu]

Where ``examples/quickstart_torch.py`` evaluates one spec in one shot,
this drives the request-serving layer (``repro_torch.service``): clients
submit *requests* (families plus a precision ask) and the engine batches
pending work across clients into fused kernel launches, dedupes equivalent
integrals via content hashing, and serves repeats straight from its
stderr-aware cache.  Six things to notice below:

1. two clients asking for the same integral share one evaluation;
2. re-asking to the *same or looser* precision costs zero launches;
3. asking for *more* precision resumes the cached counter stream (top-up):
   the result is bit-identical to having run the bigger budget from the
   start, and all the delta rounds of a wave ride in ONE multi-round fused
   kernel launch per dimension bucket;
4. with a ``state_dir`` all of the above survives process death: the cache
   journals every round to disk, so a brand-new process warm-starts the
   same streams;
5. the whole pipeline is observable (``repro_torch.obs``): pass an
   ``Observability`` bundle and every wave traces its six stages (plan /
   launch / device_execute / transfer / deposit / wal_commit), ``zmc_*``
   metrics count what the engine did, and each stream records its
   stderr-vs-rounds trajectory;
6. a parameter *sweep* is one request, not one request per point: the
   engine slices the grid into swept families and runs the whole scan
   fused (launches scale with waves and (dim, sampler) buckets, not grid
   points).

Every launch below is the fused CUDA kernel on the card (its plain PyTorch
version with ``--device cpu``), counted by ``kernels.template``.  Runs on
the card by default and raises without one.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import tempfile

import numpy as np

from repro_torch.core import (harmonic_analytic, harmonic_family,
                              gaussian_analytic, gaussian_family)
from repro_torch.kernels import template
from repro_torch.obs import Observability
from repro_torch.obs.trace import load_trace, span_totals
from repro_torch.service import IntegrationClient, IntegrationEngine


def main(device="cuda") -> dict:
    """Run every stage of the tour; returns each stage's result by name
    and the launch count of each counted stage under ``"launches"``."""
    out = {"launches": {}}
    engine = IntegrationEngine(seed=0, round_samples=8192, device=device)
    client = IntegrationClient(engine)

    # -- client A: harmonic modes; client B: an overlapping grid scan ------
    template.reset_launch_count()
    res_a = client.integrate([harmonic_family(50, 4), gaussian_family(10, 3)],
                             n_samples=32768)
    res_b = client.integrate([harmonic_family(50, 4)],   # same integrals as A!
                             n_samples=32768)
    out["launches"]["cold"] = template.launch_count()
    print(f"cold: {template.launch_count()} launches for both clients "
          f"(B deduped onto A's cache entry: from_cache={res_b.served_from_cache})")

    exact = harmonic_analytic(50, 4)
    print("first three harmonic modes (estimate +- stderr vs analytic):")
    for i in range(3):
        print(f"  F_{i+1:<3d} = {res_a.means[i]:+.5f} "
              f"+- {res_a.stderrs[i]:.1e}   exact {exact[i]:+.5f}")

    # -- warm cache: zero launches ---------------------------------------
    template.reset_launch_count()
    res_c = client.integrate([harmonic_family(50, 4)], n_samples=32768)
    out["launches"]["warm"] = template.launch_count()
    assert template.launch_count() == 0 and res_c.served_from_cache
    np.testing.assert_array_equal(res_c.means, res_b.means)
    print("warm: 0 launches, identical result")

    # -- top-up: resume the stream instead of recomputing -----------------
    # the 4 delta rounds arrive in ONE multi-round fused launch (R x B -> B)
    template.reset_launch_count()
    res_d = client.integrate([harmonic_family(50, 4)], n_samples=65536)
    out["launches"]["top_up"] = template.launch_count()
    assert template.launch_count() == 1
    print(f"top-up to 2x budget: {template.launch_count()} launch, "
          f"stderr {res_b.stderrs.max():.2e} -> {res_d.stderrs.max():.2e}")

    # -- or ask for precision directly ------------------------------------
    res_e = client.integrate([harmonic_family(50, 4)], target_stderr=2.5e-3)
    print(f"to-precision: max stderr {res_e.stderrs.max():.2e} "
          f"after {res_e.n_per_family[0]} samples")

    # -- infinite domains ride the same fused path -------------------------
    # a gaussian over R^3: canonicalization compactifies it (tangent
    # transform, Jacobian folded in-kernel), so the request buckets into
    # the SAME fused launches as finite boxes (no chunked fallback) and
    # lands on the analytic value (sigma sqrt(2 pi))^3
    template.reset_launch_count()
    res_inf = client.integrate([gaussian_family(10, 3, lo=-np.inf, hi=np.inf)],
                               n_samples=32768)
    out["launches"]["infinite"] = template.launch_count()
    out["fallback_rounds"] = engine.batcher.fallback_rounds
    exact_inf = gaussian_analytic(10, 3)
    assert template.launch_count() == 1 and engine.batcher.fallback_rounds == 0
    assert np.all(np.abs(res_inf.means - exact_inf) <= 6 * res_inf.stderrs + 1e-3)
    print(f"infinite domain: gaussian over R^3 in {template.launch_count()} "
          f"fused launch, max error "
          f"{np.abs(res_inf.means - exact_inf).max():.2e} "
          f"(stderr {res_inf.stderrs.max():.2e})")
    print(f"engine stats: {engine.stats}")
    engine.close()
    out.update(a=res_a, b=res_b, c=res_c, d=res_d, e=res_e, inf=res_inf)

    # -- durability: the cache survives process death ---------------------
    # pass state_dir= and every round deposit is journaled to disk
    # (crash-safe: fsynced + checksummed, compacted to npz on close).  A
    # new process pointing at the same dir resumes every stream at its
    # exact counter offset: zero launches for work already done,
    # bit-identical results.  `serve_integrals --state-dir` exposes the
    # same thing on the CLI.
    with tempfile.TemporaryDirectory(prefix="zmc-state-") as state_dir:
        with IntegrationEngine(seed=1, round_samples=8192, device=device,
                               state_dir=state_dir) as eng1:
            res_cold = IntegrationClient(eng1).integrate(
                [harmonic_family(50, 4)], n_samples=32768)
        # eng1 is gone ("the process died").  Boot a fresh engine on its state:
        with IntegrationEngine(seed=1, round_samples=8192, device=device,
                               state_dir=state_dir) as eng2:
            template.reset_launch_count()
            res_warm = IntegrationClient(eng2).integrate(
                [harmonic_family(50, 4)], n_samples=32768)
            assert template.launch_count() == 0 and res_warm.served_from_cache
            np.testing.assert_array_equal(res_warm.means, res_cold.means)
    print("restart: 0 launches, bit-identical result from persisted state")
    out.update(restart_cold=res_cold, restart_warm=res_warm)

    # -- telemetry: watch the engine work ---------------------------------
    # Observability.enabled() turns on tracing + convergence recording; the
    # trace file loads in Perfetto (ui.perfetto.dev) or chrome://tracing,
    # the metrics registry renders a Prometheus exposition, and every
    # stream's stderr-vs-rounds trajectory is queryable by its id from
    # ``result.stream_ids``.  Disabled (the default) costs almost nothing.
    with tempfile.TemporaryDirectory(prefix="zmc-obs-") as tmp:
        trace_path = os.path.join(tmp, "trace_wave_pipeline.json")
        obs = Observability.enabled(trace_path=trace_path)
        eng = IntegrationEngine(seed=2, round_samples=8192, device=device, obs=obs)
        res = IntegrationClient(eng).integrate([harmonic_family(50, 4)],
                                               n_samples=65536)
        (sid,) = res.stream_ids
        traj = eng.stderr_trajectory(sid)
        print(f"telemetry: stream {sid[:16]}... converged "
              f"{traj[0].stderr_max:.2e} -> {traj[-1].stderr_max:.2e} "
              f"over {traj[-1].rounds_done} rounds; "
              f"{int(obs.m['launches'].value())} launches, "
              f"{int(obs.m['waves'].value())} waves recorded")
        eng.close()
        obs.close()
        totals = span_totals(load_trace(trace_path))
        print("per-stage wall time: " +
              ", ".join(f"{k} {v * 1e3:.1f}ms" for k, v in totals.items()))
    out.update(telemetry=res, span_totals=totals)

    # -- parameter sweeps: scan a template over a grid in one request -----
    # A Boltzmann-style scan: one integrand family, evaluated over a 2-D
    # (amplitude, offset) parameter grid.  client.sweep() submits ONE
    # request; the engine slices the grid into swept families (64 points
    # each by default) and serves them on the fused kernel path: the
    # per-point parameters substitute *inside* the kernel, so a 64-point
    # grid costs one launch per (dim, sampler) bucket per wave, not 64.
    eng = IntegrationEngine(seed=3, round_samples=8192, device=device)
    sweeper = IntegrationClient(eng)
    a_axis = np.linspace(0.5, 2.0, 8)      # amplitude scan
    b_axis = np.linspace(-1.0, 1.0, 8)     # offset scan
    template.reset_launch_count()
    sweep = sweeper.sweep(harmonic_family(1, 3), {"a": a_axis, "b": b_axis},
                          n_samples=16384)
    out["launches"]["sweep"] = template.launch_count()
    surface = sweep.means.reshape(sweep.grid_shape)  # indexed by (a_i, b_j)
    print(f"sweep: {sweep.n_points} grid points over axes {sweep.axis_names} "
          f"in {template.launch_count()} fused launch(es); "
          f"surface shape {surface.shape}")

    # warm-restart top-up: the same grid at a bigger budget resumes every
    # slice's counter stream (only the delta rounds run), and a verbatim
    # re-ask is a pure cache hit, the same stream semantics as any other.
    template.reset_launch_count()
    finer = sweeper.sweep(harmonic_family(1, 3), {"a": a_axis, "b": b_axis},
                          n_samples=65536)
    delta_launches = template.launch_count()
    out["launches"]["sweep_top_up"] = delta_launches
    again = sweeper.sweep(harmonic_family(1, 3), {"a": a_axis, "b": b_axis},
                          n_samples=65536)
    assert again.served_from_cache
    np.testing.assert_array_equal(again.means, finer.means)
    print(f"sweep top-up: {delta_launches} launch(es) for the extra rounds, "
          f"re-ask free; max stderr {sweep.stderrs.max():.2e} -> "
          f"{finer.stderrs.max():.2e}")
    eng.close()
    out.update(sweep=sweep, sweep_finer=finer, sweep_again=again)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to serve (default: the card; raises without one)")
    main(ap.parse_args().device)
