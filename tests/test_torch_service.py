"""The port's integration service against repro's: stream ids
(``family_hash``) and metric names equal, the same requests served to the
same estimates within repro's MC bound (rtol=5e-5, atol=5e-3; the port
through its fused kernel's plain version, repro through its chunked
path), launches per wave within the buckets, warm restarts and crash
resumes bit-identical, and state dirs that each package loads from the
other (and that repro's auditor passes).

Every test that starts the worker thread waits with a timeout and stops
the engine in a ``finally``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.analysis.streams import audit_state_dir
from repro.launch import serve_integrals as jserve
from repro.obs import MetricsRegistry as JRegistry
from repro.obs.metrics import service_metrics as jservice_metrics
from repro.service import IntegrationEngine as JEngine
from repro.service import canonical as jcanonical
from repro.service.store import DurableStore as JStore
from repro_torch.kernels import template
from repro_torch.launch import serve_integrals
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.obs import MetricsRegistry
from repro_torch.obs.metrics import service_metrics
from repro_torch.service import (FaultPlan, IntegrationEngine,
                                 IntegrationRequest, RetryExhausted,
                                 RetryPolicy, SweepRequest, canonical,
                                 request_from_numpy)
from repro_torch.service.store import DurableStore

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

RTOL, ATOL = 5e-5, 5e-3
R = 4096                         # round quantum
N_REQ, N_FN, BUDGET = 8, 4, 2 * R
TIMEOUT = 120.0                  # seconds any one wait may take


def _workload(pkg="port", n=N_REQ, budget=BUDGET):
    mod = serve_integrals if pkg == "port" else jserve
    return mod.demo_workload(n, n_fn=N_FN, n_samples=budget)


def _serve_sync(engine, reqs):
    tickets = [engine.submit(r) for r in reqs]
    while engine.step():
        pass
    return [engine.poll(t) for t in tickets]


def _means(results):
    return np.concatenate([r.means for r in results])


def _stderrs(results):
    return np.concatenate([r.stderrs for r in results])


def _digest(results):
    return b"".join(r.means.tobytes() + r.stderrs.tobytes() for r in results)


# -- stream ids and metric names --------------------------------------------

@pytest.mark.parametrize("index", range(7), ids=lambda i: f"maker{i}")
def test_family_hash_equals_reference(index):
    """Each of demo_workload's seven makers, built independently in both
    packages (raw families: the hash compactifies first)."""
    fam = _workload(n=7)[index].families[0]
    jfam = _workload("ref", n=7)[index].families[0]
    assert canonical.family_hash(fam) == jcanonical.family_hash(jfam)
    assert (canonical.canonical_family(fam).compact
            == jcanonical.canonical_family(jfam).compact == (index >= 5))


def _arrays(tree):
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("compactified", [False, True])
def test_request_from_numpy_of_reference_requests(compactified):
    """repro's requests, raw or already compactified, carried over as
    arrays: the same names and stream ids."""
    for jreq in _workload("ref", n=7):
        fams = [jcanonical.canonical_family(f) if compactified else f
                for f in jreq.families]
        req = request_from_numpy(
            [dict(kernel=f.kernel, params=_arrays(f.params),
                  domains=np.asarray(f.domains), name=f.name,
                  compact=f.compact) for f in fams],
            n_samples=jreq.n_samples)
        assert req.n_samples == jreq.n_samples
        for fam, jfam in zip(req.families, fams):
            assert fam.name == jfam.name and fam.compact == jfam.compact
            assert canonical.family_hash(fam) == jcanonical.family_hash(jfam)


def test_metric_names_and_labels_equal_reference():
    def declared(metrics):
        return {k: (m.name, tuple(m.labelnames), type(m).__name__)
                for k, m in metrics.items()}
    got = declared(service_metrics(MetricsRegistry()))
    want = declared(jservice_metrics(JRegistry()))
    assert got == want
    assert len(got) == len(want) > 20


# -- the same requests through both engines ---------------------------------

@pytest.fixture(scope="module")
def served():
    """The port's engine (CPU, the fused kernel's plain version) and
    repro's (its chunked path) on the same eight requests."""
    eng = IntegrationEngine(round_samples=R, device="cpu")
    template.reset_launch_count()
    got = _serve_sync(eng, _workload())
    launches = template.launch_count()
    eng.close()
    jeng = JEngine(round_samples=R, use_kernel=False)
    want = _serve_sync(jeng, _workload("ref"))
    jeng.close()
    return eng, got, launches, want


def test_engine_vs_reference_engine(served):
    eng, got, _, want = served
    assert [r.names for r in got] == [r.names for r in want]
    assert [r.stream_ids for r in got] == [r.stream_ids for r in want]
    np.testing.assert_allclose(_means(got), _means(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_stderrs(got), _stderrs(want), rtol=RTOL,
                               atol=ATOL)
    assert [r.n_per_family for r in got] == [r.n_per_family for r in want]


def test_launches_per_wave_within_buckets_and_no_fallback(served):
    eng, _, launches, _ = served
    dims = {f.dim for r in _workload() for f in r.families}
    assert eng.stats.waves >= 1
    assert launches <= len(dims) * eng.stats.waves
    assert eng.batcher.fallback_rounds == 0
    assert eng.obs.m["fallback_rounds"].value() == 0
    assert eng.obs.m["launches"].value() == launches


def test_pipelined_worker_matches_synchronous(served):
    """All requests queued before the worker starts, so its first wave is
    the synchronous one: bit-identical results."""
    _, want, _, _ = served
    eng = IntegrationEngine(round_samples=R, device="cpu")
    try:
        tickets = [eng.submit(r) for r in _workload()]
        eng.start()
        got = [eng.result(t, timeout=TIMEOUT) for t in tickets]
    finally:
        eng.close(timeout=TIMEOUT)
    assert not eng.running
    assert _digest(got) == _digest(want)
    assert eng.batcher.fallback_rounds == 0


def test_not_ported_paths_raise(tmp_path):
    fams = _workload(n=1)[0].families
    # adaptive requests, Sobol requests and sweeps are ported now
    req = IntegrationRequest.make(fams, target_stderr=0.1, adaptive=True)
    assert req.adaptive and req.target_stderr == 0.1
    assert IntegrationRequest.make(fams, n_samples=R, sampler="sobol").sampler == "sobol"
    assert isinstance(serve_integrals.demo_workload(2, sweeps=1)[-1], SweepRequest)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IntegrationEngine()
    # the mesh is ported now: on a (1, 1) mesh of a world-size-1 gloo group
    # the engine and the launcher serve the single-device bits
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        reqs = _workload()
        want = _serve_sync(IntegrationEngine(round_samples=R, device="cpu"), reqs)
        got = _serve_sync(IntegrationEngine(round_samples=R, device="cpu",
                                            mesh=make_mesh_for(device="cpu")), reqs)
        assert _digest(got) == _digest(want)
        argv = ["--device", "cpu", "--requests", "4", "--n-fn", "2",
                "--samples", str(2 * R), "--round-samples", str(R)]
        plain = serve_integrals.main(argv)
        meshed = serve_integrals.main(argv + ["--mesh"])
        assert _digest(meshed["results"]) == _digest(plain["results"])
        assert meshed["launches"] == plain["launches"]
    finally:
        dist.destroy_process_group()


# -- durable state -----------------------------------------------------------

@pytest.fixture(scope="module")
def port_state(tmp_path_factory):
    """A state dir the port wrote serving the workload, and its results."""
    d = str(tmp_path_factory.mktemp("port_state"))
    eng = IntegrationEngine(round_samples=R, device="cpu", state_dir=d)
    results = _serve_sync(eng, _workload())
    eng.close()
    return d, results


def test_warm_restart_zero_launches_equal_digest(port_state):
    d, first = port_state
    eng = IntegrationEngine(round_samples=R, device="cpu", state_dir=d)
    template.reset_launch_count()
    try:
        again = _serve_sync(eng, _workload())
    finally:
        eng.close()
    assert template.launch_count() == 0
    assert all(r.served_from_cache for r in again)
    assert _digest(again) == _digest(first)


def test_reference_auditor_passes_port_state(port_state):
    report = audit_state_dir(port_state[0])
    assert report.ok, report.violations
    assert report.streams == 6           # 8 requests, 2 verbatim re-asks


def _entries(state):
    return {c: (e.fn_offset, e.n_fn, e.round_samples, e.n, e.rounds_done,
                np.asarray(e.s1).tobytes(), np.asarray(e.s2).tobytes())
            for c, e in state.entries.items()}


def test_reference_store_loads_port_state(port_state):
    d = port_state[0]
    want, got = JStore(d, lease_ttl=None).load(), DurableStore(d, lease_ttl=None).load()
    assert _entries(want) == _entries(got) and len(got.entries) == 6
    assert (want.next_id, want.round_samples) == (got.next_id, got.round_samples)


def test_port_loads_and_serves_reference_state(tmp_path):
    """A state dir repro's engine wrote: the port's store loads the same
    entries, and the port's engine serves the same requests from it with
    zero launches (equal stream ids) to repro's results within the MC
    bound."""
    d = str(tmp_path)
    jeng = JEngine(round_samples=R, use_kernel=False, state_dir=d)
    want = _serve_sync(jeng, _workload("ref", n=4))
    jeng.close()
    assert _entries(DurableStore(d, lease_ttl=None).load()) == \
        _entries(JStore(d, lease_ttl=None).load())
    eng = IntegrationEngine(round_samples=R, device="cpu", state_dir=d)
    template.reset_launch_count()
    try:
        got = _serve_sync(eng, _workload(n=4))
    finally:
        eng.close()
    assert template.launch_count() == 0
    np.testing.assert_array_equal(_means(got), _means(want))


def test_crash_mid_wave_resumes_bit_identical(tmp_path):
    """Three waves of one round each; the second wave's transfer crashes
    (the engine is abandoned without a shutdown snapshot, as a killed
    process would be); a new engine on the same state dir finishes the
    streams, bit-identical to an uninterrupted run."""
    reqs = _workload(n=5, budget=3 * R)
    kw = dict(round_samples=R, device="cpu", max_rounds_per_wave=1)
    clean = IntegrationEngine(**kw)
    want = _serve_sync(clean, reqs)
    clean.close()

    d = str(tmp_path)
    crashed = IntegrationEngine(
        **kw, state_dir=d, faults=FaultPlan({"transfer": 1}),
        retry_policy=RetryPolicy(max_attempts=1))
    for r in reqs:
        crashed.submit(r)
    assert crashed.step()                       # wave 1 deposits
    with pytest.raises(RetryExhausted):
        crashed.step()                          # wave 2 dies in transfer
    rounds = {e.chash: e.rounds_done for e in crashed.cache._entries.values()}
    assert set(rounds.values()) == {1}
    crashed.store.close()                       # no snapshot: a kill

    resumed = IntegrationEngine(**kw, state_dir=d)
    assert len(resumed.cache.recovered.entries) == len(rounds)
    template.reset_launch_count()
    try:
        got = _serve_sync(resumed, reqs)
    finally:
        resumed.close()
    assert resumed.stats.waves == 2             # only the missing rounds
    assert _digest(got) == _digest(want)
    assert audit_state_dir(d).ok


def test_store_format_round_trip_fields():
    """The port's store is the reference's format: the same dataclass
    fields for entries and recovered state."""
    from repro.service import store as jstore
    from repro_torch.service import store
    for name in ("EntryState", "RecoveredState"):
        assert [f.name for f in dataclasses.fields(getattr(store, name))] == \
            [f.name for f in dataclasses.fields(getattr(jstore, name))]
