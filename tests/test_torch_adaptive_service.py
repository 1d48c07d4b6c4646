"""The service's adaptive requests in the port against repro's: state dirs
the reference auditor passes, an abandoned run resumed bit-identical, a
reference-written grid chain adopted with the same stream ids, estimates
that agree with the reference engine's (repro's BENCH_10 knobs), and the
adaptive flag ignored without a target or on a sweep."""

import numpy as np
import pytest
import torch

from repro.analysis.streams import audit_state_dir
from repro.core import genz as jgenz
from repro.core import integrand as jint
from repro.service import IntegrationEngine as JEngine
from repro.service.api import IntegrationClient as JClient
from repro.service.api import IntegrationRequest as JRequest
from repro_torch.core import genz, integrand
from repro_torch.service import IntegrationEngine, IntegrationRequest
from repro_torch.service.api import IntegrationClient
from test_torch_adaptive import ADAPT_KW, INF, _port

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


# -- the service: adaptive requests -----------------------------------------

def _corner():
    return genz.corner_peak(2, 3, difficulty=4.0)[0]


def _engine(**kw):
    return IntegrationEngine(device="cpu", **ADAPT_KW, **kw)


@pytest.fixture(scope="module")
def adapted_run(tmp_path_factory):
    """An uninterrupted adaptive run on a state dir, and its result."""
    d = str(tmp_path_factory.mktemp("adapted"))
    eng = _engine(state_dir=d)
    try:
        res = IntegrationClient(eng).integrate([_corner()], target_stderr=5e-5,
                                               adaptive=True)
        refits = eng.obs.m["grid_refits"].value()
        chain = eng.cache.grid_chain(res.stream_ids[0])
    finally:
        eng.close()
    return d, res, refits, chain


def test_adaptive_request_refits_and_meets_target(adapted_run):
    _, res, _, chain = adapted_run
    exact = genz.corner_peak(2, 3, difficulty=4.0)[1]
    assert np.all(res.stderrs <= 5e-5)
    assert np.all(np.abs(res.means - exact) <= 6 * res.stderrs)
    assert [g.epoch for g in chain] == list(range(1, len(chain) + 1))
    assert len(chain) >= 2                      # at least one refit


def test_reference_auditor_passes_adaptive_state(adapted_run):
    report = audit_state_dir(adapted_run[0])
    assert report.ok, report.violations


def test_abandoned_adaptive_run_resumes_bit_identical(adapted_run, tmp_path):
    _, want, _, _ = adapted_run
    d = str(tmp_path)
    eng = _engine(state_dir=d)
    eng.submit(IntegrationRequest.make([_corner()], target_stderr=5e-5,
                                       adaptive=True))
    for _ in range(2):
        eng.step()
    del eng                    # abandoned mid-flight: no close(), no snapshot
    eng = _engine(state_dir=d)
    try:
        got = IntegrationClient(eng).integrate([_corner()], target_stderr=5e-5,
                                               adaptive=True)
    finally:
        eng.close()
    assert got.stream_ids == want.stream_ids
    assert got.n_per_family == want.n_per_family
    assert got.means.tobytes() == want.means.tobytes()
    assert got.stderrs.tobytes() == want.stderrs.tobytes()
    assert audit_state_dir(d).ok


def test_port_adopts_reference_grid_chain(tmp_path):
    """A state dir repro's engine wrote two adaptive waves into: the port
    adopts the journaled chain tip (the same stream id, no refit of the
    epoch it holds) and finishes the request, auditable by repro."""
    d = str(tmp_path)
    jeng = JEngine(state_dir=d, use_kernel=False, **ADAPT_KW)
    jt = jeng.submit(JRequest.make([jgenz.corner_peak(2, 3, difficulty=4.0)[0]],
                                   target_stderr=5e-5, adaptive=True))
    for _ in range(2):
        jeng.step()
    tip = [e.chash for e in jeng._pending[jt].entries]
    del jeng
    eng = _engine(state_dir=d)
    try:
        t = eng.submit(IntegrationRequest.make([_corner()], target_stderr=5e-5,
                                               adaptive=True))
        assert [e.chash for e in eng._pending[t].entries] == tip
        res = IntegrationClient(eng).wait(t)
    finally:
        eng.close()
    assert np.all(res.stderrs <= 5e-5)
    assert audit_state_dir(d).ok


def test_adaptive_estimates_agree_with_reference():
    """A fresh fit in each package (edges equal up to their low bits):
    both reach the target and agree within 6 standard errors."""
    jfam = jint.gaussian_family(2, 2, sigma=[0.2, 0.35], lo=-INF, hi=INF)
    fam = _port(jfam)
    jeng = JEngine(use_kernel=False, **ADAPT_KW)
    want = JClient(jeng).integrate([jfam], target_stderr=2e-3, adaptive=True)
    eng = _engine()
    got = IntegrationClient(eng).integrate([fam], target_stderr=2e-3,
                                           adaptive=True)
    assert eng.obs.m["adapted_streams"].value() >= 1
    assert np.all(got.stderrs <= 2e-3)
    tol = 6 * (got.stderrs + want.stderrs)
    assert np.all(np.abs(got.means - want.means) <= tol)


@pytest.mark.parametrize("case", ["budget_only", "swept"])
def test_adaptive_flag_without_target_or_on_a_sweep_runs_fixed(case):
    if case == "budget_only":
        fams = [_corner()]
        kw = dict(n_samples=8192)
    else:
        fams = [integrand.harmonic_family(1, 2).swept_over(
            {"a": np.linspace(0.5, 2.0, 4).astype(np.float32)})]
        kw = dict(target_stderr=1e-2)
    eng = _engine()
    res = IntegrationClient(eng).integrate(fams, adaptive=True, **kw)
    fixed = IntegrationClient(_engine()).integrate(fams, **kw)
    assert res.stream_ids == fixed.stream_ids
    assert res.means.tobytes() == fixed.means.tobytes()
    assert eng.obs.m["adapted_streams"].value() == 0 and not eng._adaptive


def test_engine_checks_adapt_knobs():
    with pytest.raises(ValueError, match="adapt_bins"):
        IntegrationEngine(device="cpu", adapt_bins=1)
    with pytest.raises(ValueError, match="adapt_max_epochs"):
        IntegrationEngine(device="cpu", adapt_max_epochs=0)
