"""Parameter sweeps against repro's: the sweep column map, table columns
and packed swept rows bit for bit; swept families' sums within repro's
bounds and against their points as families of their own; the bucket plan
and its sweep pairs; canonical slices, their names and stream hashes as
repro's; the service end to end (``SweepRequest``, ``sweep_partial``,
overlapping sweeps deduping, sweep streams surviving a kill and passing
repro's auditor); ``demo_workload(sweeps=k)``; and ``ZMCFunctional``.

CPU sums are not bit-stable across tensor shapes (PyTorch picks its
reduction order by shape), so a swept point and its own family agree
here within tolerance; the CUDA kernel's bit identity is checked on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis.streams import audit_state_dir
from repro.core import direct_mc as jdirect
from repro.core import genz as jgenz
from repro.core import integrand as jint
from repro.core import rng as jrng
from repro.core.functional import ZMCFunctional as JFunctional
from repro.kernels import registry as jregistry
from repro.kernels import template as jtemplate
from repro.kernels.mc_eval import multi as jmulti
from repro.launch import serve_integrals as jserve
from repro.service import IntegrationClient as JClient
from repro.service import IntegrationEngine as JEngine
from repro.service import canonical as jcanonical
from repro_torch.core import direct_mc, genz, integrand
from repro_torch.core.functional import ZMCFunctional
from repro_torch.kernels import registry, template
from repro_torch.kernels.mc_eval import multi
from repro_torch.launch import serve_integrals
from repro_torch.service import (IntegrationClient, IntegrationEngine,
                                 IntegrationRequest, SweepRequest, SweepResult,
                                 canonical)

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

RTOL, ATOL = 5e-5, 5e-3          # repro's MC kernel-vs-engine bound
R = 4096                         # the service's round quantum here
INF = np.inf
ROOT = Path(__file__).resolve().parent.parent

A6 = np.linspace(0.5, 2.0, 6).astype(np.float32)
B6 = np.linspace(-1.0, 1.0, 6).astype(np.float32)
K4 = np.stack([np.full(3, 5.0 + j, np.float32) for j in range(4)])


def _port(jfam, **kw):
    return integrand.family_from_numpy(
        jfam.kernel, {k: np.asarray(v) for k, v in jfam.params.items()},
        np.asarray(jfam.domains), jfam.name, **kw)


def _arrays(tree):
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    return np.asarray(tree)


# (name, repro template, table): every sweepable parameter of every form
SWEEPS = {
    "harmonic_ab": (lambda: jint.harmonic_family(1, 3), {"a": A6, "b": B6}),
    "harmonic_k": (lambda: jint.harmonic_family(1, 3), {"k": K4}),
    "abs_sum_cs": (lambda: jint.abs_sum_family(1, 2, [1.0]),
                   {"c": A6[:4], "s": np.stack([A6[:4], B6[:4]], 1)}),
    "gaussian_sigma": (lambda: jint.gaussian_family(1, 2, lo=-INF, hi=INF),
                       {"sigma": A6}),
    "genz_osc_a": (lambda: jgenz.oscillatory(1, 3)[0], {"a": K4 / 5.0}),
    "genz_corner_a": (lambda: jgenz.corner_peak(1, 2)[0],
                      {"a": np.stack([A6, A6[::-1]], 1)}),
}


def _pair(name, compactify=True):
    """The repro swept family and the port's, built the same way."""
    make, table = SWEEPS[name]
    jt = make()
    jsw = jt.swept_over(table)
    sw = _port(jt).swept_over(table)
    if compactify:
        jsw, sw = jsw.compactified(), sw.compactified()
    return jsw, sw


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_columns_and_packed_rows_bit_exact(name):
    jsw, sw = _pair(name)
    assert sw.swept == jsw.swept and sw.compact == jsw.compact
    assert sw.name == jsw.name and sw.n_fn == jsw.n_fn
    form, jform = registry.form(sw.kernel), jregistry.form(jsw.kernel)
    assert template.sweep_col_map(form, sw.inner()) == \
        jtemplate.sweep_col_map(jform, jsw.inner())
    np.testing.assert_array_equal(template.sweep_table_cols(sw.inner()).numpy(),
                                  np.asarray(jtemplate.sweep_table_cols(jsw.inner())))
    _, packed = template.body_and_packed(form, sw)
    _, jpacked = jtemplate.body_and_packed(jform, jsw)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    assert template.packed_cols(form, sw) == jtemplate.packed_cols(jform, jsw)
    np.testing.assert_array_equal(sw.domains.numpy(), np.asarray(jsw.domains))
    pairs = template.sweep_pairs(form, sw)
    base = form.n_cols(sw.dim)
    assert [d for d, _ in pairs] == list(jtemplate.sweep_col_map(jform, jsw.inner()))
    assert [s for _, s in pairs] == list(range(base, base + len(pairs)))
    assert template.transform_col(form, sw) == (base + len(pairs) if sw.compact else -1)


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_swept_sums_vs_reference(name):
    """Chunked and fused (plain version) sums of a swept family against
    repro's chunked engine, for both samplers."""
    jsw, sw = _pair(name)
    key = jrng.fold_key(23, 0)
    for sampler in ("mc", "sobol"):
        want = jdirect.family_sums(jsw, 2048 + 321, key, fn_offset=5,
                                   chunk=1024, sampler=sampler)
        for use_kernel in (False, True):
            got = direct_mc.family_sums(sw, 2048 + 321, key, fn_offset=5,
                                        chunk=1024, use_kernel=use_kernel,
                                        sampler=sampler)
            rtol, atol = (RTOL, ATOL) if sampler == "mc" else (1e-4, 1e-2)
            np.testing.assert_allclose(got.s1.numpy(), np.asarray(want.s1),
                                       rtol=rtol, atol=atol)
            np.testing.assert_allclose(got.s2.numpy(), np.asarray(want.s2),
                                       rtol=rtol, atol=atol)


@pytest.mark.parametrize("sampler", ["mc", "sobol"])
def test_swept_vs_per_point(sampler):
    """One fused launch over the grid against one launch per point at the
    same fn ids (bit-identical on the card; within tolerance here)."""
    sw = integrand.harmonic_family(1, 3).swept_over({"a": A6, "k": np.repeat(K4[:1], 6, 0)})
    key = jrng.fold_key(8, 8)
    template.reset_launch_count()
    fused = direct_mc.family_sums(sw, 3000, key, use_kernel=True, sampler=sampler)
    assert template.launch_count() == 1
    for j in range(len(A6)):
        pt = integrand.harmonic_family(1, 3, a=A6[j:j + 1], k=K4[:1])
        one = direct_mc.family_sums(pt, 3000, key, fn_offset=j, use_kernel=True,
                                    sampler=sampler)
        torch.testing.assert_close(fused.s1[j:j + 1], one.s1, rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(fused.s2[j:j + 1], one.s2, rtol=1e-6, atol=1e-5)


def test_sweep_errors_as_reference():
    h = integrand.harmonic_family(1, 2)
    with pytest.raises(ValueError, match="single function"):
        integrand.harmonic_family(2, 2).swept_over({"a": A6})
    with pytest.raises(ValueError, match="not in template params"):
        h.swept_over({"z": A6})
    with pytest.raises(ValueError, match="disagree on n_points"):
        h.swept_over({"a": A6, "b": B6[:3]})
    with pytest.raises(ValueError, match="per-point shape"):
        h.swept_over({"k": A6})
    with pytest.raises(ValueError, match="before compactifying"):
        integrand.gaussian_family(1, 2, lo=-INF, hi=INF).compactified().swept_over(
            {"sigma": A6})
    # genz_osc's u does not round-trip through its packed columns
    osc = genz.oscillatory(1, 2)[0].swept_over({"u": np.tile(A6[:, None], (1, 2))})
    form = registry.form(osc.kernel)
    assert not form.supports(dim=2, sweep=osc.swept)
    with pytest.raises(ValueError, match="cannot sweep parameter 'u'"):
        template.sweep_col_map(form, osc)
    plan = multi.plan_spec(integrand.MultiFunctionSpec.from_families([osc]))
    assert plan.unfused == (0,)
    with pytest.raises(ValueError, match="sweepable"):
        registry.lookup(osc.kernel, dim=2, sweep=("u",), required=True)


def test_plan_spec_swept_as_reference_and_plain_vs_pallas():
    """A dim-2 bucket of two swept families (2 and 1 table columns) and a
    plain one: the same packed operands as repro's plan, the sweep pairs
    per block, and the plain version with R = 2 rounds against repro's
    Pallas kernel (interpret mode)."""
    jfams = [jint.harmonic_family(1, 2).swept_over({"a": A6, "b": B6}),
             jint.gaussian_family(1, 2).swept_over({"sigma": np.linspace(0.5, 2, 20)}),
             jint.harmonic_family(5, 2)]
    fams = [_port(jint.harmonic_family(1, 2)).swept_over({"a": A6, "b": B6}),
            _port(jint.gaussian_family(1, 2)).swept_over({"sigma": np.linspace(0.5, 2, 20)}),
            _port(jint.harmonic_family(5, 2))]
    (jb,) = jmulti.plan_spec(jint.MultiFunctionSpec.from_families(jfams)).buckets
    (b,) = multi.plan_spec(integrand.MultiFunctionSpec.from_families(fams)).buckets
    assert b.name == jb.name
    for name in ("packed", "lo", "hi", "fn_ids"):
        np.testing.assert_array_equal(getattr(b, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    # blocks: the (a, b) sweep, two of the sigma sweep, the plain family
    assert b.block_sweep.tolist() == [[0, 0, 0, -1], [4, 1, 1, -1],
                                      [1, -1, -1, -1], [5, -1, -1, -1]]
    # block_meta: forms, transform columns, the sweep pairs, then the
    # grid-edge columns and bins (no block adapted)
    assert torch.equal(b.block_meta[2:-2], b.block_sweep)
    assert b.block_meta[-2:].tolist() == [[-1] * 4, [0] * 4]
    n, r = 2048 + 5, 2
    starts = {0: 0, 1: 7, 2: (2**32 - 3000) // n}
    key = jrng.fold_key(3, 5)
    nsb = math.ceil(n / jtemplate.S_BLK)
    want = np.asarray(jtemplate.fused_mc_pallas(
        jtemplate.pack_scalars(key, 0, n, round_stride=n), jb.fn_ids, jb.packed,
        jb.lo, jb.hi, form_ids=jb.form_ids,
        round_base=jmulti._round_base_for(jb, starts, n), dim=2,
        n_sample_blocks=nsb, bodies=jb.bodies, n_rounds=r, interpret=True,
        name=f"{jb.name}_r{r}"))
    got = template.fused_mc_plain(
        template.pack_scalars(key, 0, n, round_stride=n), b.fn_ids, b.packed,
        b.lo, b.hi, b.block_forms, dim=2, n_sample_blocks=nsb, n_rounds=r,
        round_base=multi._round_base_for(b, starts, n), block_sweep=b.block_sweep)
    real = np.concatenate([np.arange(s.row_start, s.row_start + s.n_fn)
                           for s in b.slices])
    np.testing.assert_allclose(got.numpy()[:, real], want[:, real], rtol=RTOL,
                               atol=ATOL)


def test_block_sweep_checks():
    ops = (template.pack_scalars((0, 0), 0, 16), torch.arange(16),
           torch.zeros(16, 5), torch.zeros(16, 2), torch.ones(16, 2),
           torch.zeros(1, dtype=torch.int32))
    bad = [torch.tensor([[3], [2]], dtype=torch.int32),       # reads a base column
           torch.tensor([[0], [7]], dtype=torch.int32),       # past the packed row
           torch.tensor([[0, 1], [4, 2]], dtype=torch.int32),  # table out of order
           torch.zeros(2, 2, dtype=torch.int32)]               # wrong block count
    for sweep in bad:
        with pytest.raises(ValueError, match="block_sweep"):
            template.fused_mc_plain(*ops, dim=2, n_sample_blocks=1,
                                    block_sweep=sweep)


# -- canonical slices and stream ids -------------------------------------------

GRIDS = {
    "ab": (lambda m: m.harmonic_family(1, 2), {"b": B6, "a": A6}),
    "k": (lambda m: m.harmonic_family(1, 3), {"k": K4}),
    "sigma_orthant": (lambda m: m.gaussian_family(1, 3, lo=0.0, hi=INF),
                      {"sigma": np.linspace(0.5, 2.0, 9)}),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_sweep_slices_and_hashes_equal_reference(name):
    make, grid = GRIDS[name]
    jf, jshape, jnames = jcanonical.sweep_slices(make(jint), grid, slice_points=5)
    f, shape, names = canonical.sweep_slices(make(integrand), grid, slice_points=5)
    assert (shape, names) == (jshape, jnames)
    assert [x.name for x in f] == [x.name for x in jf]
    assert [x.n_fn for x in f] == [x.n_fn for x in jf]
    assert [canonical.family_hash(x, canonicalize=False) for x in f] == \
        [jcanonical.family_hash(x, canonicalize=False) for x in jf]
    assert canonical.spec_hash(f, sampler="sobol") == \
        jcanonical.spec_hash(jf, sampler="sobol")
    assert canonical.DEFAULT_SWEEP_SLICE == jcanonical.DEFAULT_SWEEP_SLICE == 64
    table, tshape = canonical.grid_table(canonical.canonical_grid(grid))
    jtable, _ = jcanonical.grid_table(jcanonical.canonical_grid(grid))
    assert tshape == shape and table.keys() == jtable.keys()
    for k in table:
        np.testing.assert_array_equal(table[k], jtable[k])


def test_swept_family_from_numpy_of_a_reference_slice():
    """A repro slice's arrays rebuild the same family (swept=, compact=)."""
    jsl = jcanonical.sweep_slices(jint.gaussian_family(1, 2, lo=-INF, hi=INF),
                                  {"sigma": A6})[0][0]
    fam = integrand.family_from_numpy(jsl.kernel, _arrays(jsl.params),
                                      np.asarray(jsl.domains), jsl.name,
                                      compact=jsl.compact, swept=jsl.swept)
    assert canonical.family_hash(fam, canonicalize=False) == \
        jcanonical.family_hash(jsl, canonicalize=False)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0.0, 1.0, (6, 32, 2)).astype(np.float32))
    own = canonical.sweep_slices(integrand.gaussian_family(1, 2, lo=-INF, hi=INF),
                                 {"sigma": A6})[0][0]
    torch.testing.assert_close(fam.eval_batch(x), own.eval_batch(x))


# -- the service ---------------------------------------------------------------

def _drain(engine):
    while engine.step():
        pass


A4 = np.linspace(0.5, 2.0, 4).astype(np.float32)
B2 = np.asarray([-0.5, 1.5], np.float32)


@pytest.mark.parametrize("sampler", ["mc", "sobol"])
def test_sweep_vs_reference_sweep(sampler):
    """The same sweep through both engines: grid geometry, slice stream
    ids, and per-point means within repro's MC bound."""
    want = JClient(JEngine(round_samples=R, use_kernel=False)).sweep(
        jint.harmonic_family(1, 2), {"a": A4, "b": B2}, n_samples=2 * R,
        sampler=sampler)
    eng = IntegrationEngine(round_samples=R, device="cpu", sweep_slice_points=3)
    jeng = JEngine(round_samples=R, use_kernel=False, sweep_slice_points=3)
    got = IntegrationClient(eng).sweep(integrand.harmonic_family(1, 2),
                                       {"a": A4, "b": B2}, n_samples=2 * R,
                                       sampler=sampler)
    want3 = JClient(jeng).sweep(jint.harmonic_family(1, 2), {"a": A4, "b": B2},
                                n_samples=2 * R, sampler=sampler)
    assert isinstance(got, SweepResult) and got.complete
    assert (got.grid_shape, got.axis_names, got.n_points) == ((4, 2), ("a", "b"), 8)
    assert got.stream_ids == want3.stream_ids and len(got.stream_ids) == 3
    assert got.names == want3.names
    assert got.points_done.all() and eng.batcher.fallback_rounds == 0
    np.testing.assert_allclose(got.means, want.means, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.stderrs, want.stderrs, rtol=RTOL, atol=ATOL)


def test_overlapping_sweeps_dedupe_at_subgrid_level():
    engine = IntegrationEngine(round_samples=R, device="cpu", sweep_slice_points=4)
    client = IntegrationClient(engine)
    template.reset_launch_count()
    first = client.sweep(integrand.harmonic_family(1, 2), {"a": A4, "b": B2},
                         n_samples=R)
    assert template.launch_count() == 1
    # extend the slowest axis: the first 8 points re-enumerate the first
    # sweep's two slices exactly, only the third slice is new
    a6 = np.concatenate([A4, [2.5, 3.0]]).astype(np.float32)
    template.reset_launch_count()
    second = client.sweep(integrand.harmonic_family(1, 2), {"a": a6, "b": B2},
                          n_samples=R)
    assert template.launch_count() == 1
    assert second.stream_ids[:2] == first.stream_ids
    np.testing.assert_array_equal(second.means[:8], first.means)
    template.reset_launch_count()
    again = client.sweep(integrand.harmonic_family(1, 2), {"b": B2, "a": A4},
                         n_samples=R)
    assert template.launch_count() == 0 and again.served_from_cache
    np.testing.assert_array_equal(again.means, first.means)


def test_sweep_partial_streams_points():
    engine = IntegrationEngine(round_samples=R, device="cpu", sweep_slice_points=3,
                               max_items_per_wave=1)
    ticket = engine.submit(SweepRequest.make(
        integrand.harmonic_family(1, 2), {"a": A4, "b": B2}, n_samples=R))
    snap = engine.sweep_partial(ticket)
    assert not snap.complete and not snap.points_done.any()
    assert np.isnan(snap.means).all() and np.isinf(snap.stderrs).all()
    assert engine.step()                         # one slice's round
    snap = engine.sweep_partial(ticket)
    assert snap.points_done.sum() == 3 and np.isfinite(snap.means[snap.points_done]).all()
    inc = engine.sweep_partial(ticket, since=snap.points_done)
    assert np.isnan(inc.means[snap.points_done]).all()
    with pytest.raises(ValueError, match="since mask"):
        engine.sweep_partial(ticket, since=np.ones(3, bool))
    _drain(engine)
    final = engine.sweep_partial(ticket)
    assert final.complete and final.points_done.all()
    np.testing.assert_array_equal(final.means[:3], snap.means[:3])
    with pytest.raises(TypeError, match="not a sweep"):
        engine.sweep_partial(engine.submit(IntegrationRequest.make(
            [integrand.gaussian_family(2, 2)], n_samples=R)))


def test_sweep_capability_checked_at_submit():
    engine = IntegrationEngine(round_samples=R, device="cpu")
    tmpl = genz.oscillatory(1, 2)[0]
    with pytest.raises(ValueError, match="sweepable"):
        engine.submit(SweepRequest.make(tmpl, {"u": np.tile(A4[:, None], (1, 2))},
                                        n_samples=R))
    with pytest.raises(ValueError, match="single function"):
        SweepRequest.make(integrand.harmonic_family(2, 2), {"a": A4}, n_samples=R)
    with pytest.raises(ValueError, match="unknown sampler"):
        SweepRequest.make(integrand.harmonic_family(1, 2), {"a": A4}, n_samples=R,
                          sampler="halton")


def test_sweep_streams_survive_a_kill_and_pass_the_auditor(tmp_path):
    """Sobol and MC sweep streams in a state dir: a killed engine (no
    shutdown snapshot) restarts warm and serves both sweeps with zero
    launches and equal means; repro's auditor and its CLI pass the dir."""
    d = str(tmp_path)
    reqs = [SweepRequest.make(integrand.harmonic_family(1, 2), {"a": A4, "b": B2},
                              n_samples=2 * R, sampler=s) for s in ("mc", "sobol")]
    eng = IntegrationEngine(round_samples=R, device="cpu", state_dir=d,
                            sweep_slice_points=4, max_rounds_per_wave=1)
    tickets = [eng.submit(r) for r in reqs]
    _drain(eng)
    first = [eng.poll(t) for t in tickets]
    eng.store.close()                            # no snapshot: a kill
    again = IntegrationEngine(round_samples=R, device="cpu", state_dir=d,
                              sweep_slice_points=4)
    template.reset_launch_count()
    try:
        got = [again.poll(again.submit(r)) for r in reqs]
    finally:
        again.close()
    assert template.launch_count() == 0
    assert all(g.served_from_cache for g in got)
    for g, f in zip(got, first):
        np.testing.assert_array_equal(g.means, f.means)
    report = audit_state_dir(d)
    assert report.ok, report.violations
    assert report.streams == 4
    out = subprocess.run([sys.executable, "-m", "repro.analysis", "--state-dir", d],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stdout + out.stderr


def test_demo_workload_sweeps_as_reference():
    got = serve_integrals.demo_workload(3, n_fn=2, n_samples=R, sweeps=2)
    want = jserve.demo_workload(3, n_fn=2, n_samples=R, sweeps=2)
    assert [type(r).__name__ for r in got] == [type(r).__name__ for r in want]
    for g, w in zip(got[3:], want[3:]):
        assert g.template.name == w.template.name and g.grid.keys() == w.grid.keys()
        for k in g.grid:
            np.testing.assert_array_equal(g.grid[k], w.grid[k])
    eng = IntegrationEngine(round_samples=R, device="cpu")
    tickets = [eng.submit(r) for r in got]
    _drain(eng)
    res = [eng.poll(t) for t in tickets]
    assert all(isinstance(r, SweepResult) for r in res[3:])
    assert eng.batcher.fallback_rounds == 0


def test_functional_vs_reference():
    """ZMCFunctional: one integrand over a parameter grid, the port's
    batched fn against repro's per-point one, as one family each."""
    grid = {"k": np.linspace(1.0, 4.0, 7).astype(np.float32)}
    dom = [[0.0, 1.0], [0.0, 2.0]]

    def jfn(x, p):
        import jax.numpy as jnp
        return jnp.cos(p["k"] * x[..., 0]) * x[..., 1]

    def fn(x, p):
        return torch.cos(p["k"][:, None] * x[..., 0]) * x[..., 1]

    want = JFunctional(jfn, grid, dom, n_samples=3000, seed=2).evaluate(2)
    got = ZMCFunctional(fn, grid, dom, n_samples=3000, seed=2,
                        device="cpu").evaluate(2)
    assert got.names == want.names == ("functional",)
    np.testing.assert_allclose(got.means, want.means, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.stderrs, want.stderrs, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="domain must be"):
        ZMCFunctional(fn, grid, [0.0, 1.0], device="cpu")
