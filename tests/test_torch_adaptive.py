"""VEGAS importance grids in the port against repro's: grid edges and
refits bit for bit given the same float64 weights, the map and the pilot
within float32 tolerance (rtol=1e-4), adapted packed rows and bucket
plans bit for bit, adapted sums through the fused kernel's plain version
within repro's bounds of its fused interpret path (MC rtol=5e-5,
atol=5e-3; Sobol rtol=1e-4, atol=1e-2), and the service's adaptive
requests: state dirs the reference auditor passes, resumes bit-identical,
reference-written grid chains adopted with the same stream ids (those in
test_torch_adaptive_service.py; the Sobol interpret-mode case in
test_torch_adaptive_sobol.py).

Grids are built from numpy, not from hypothesis strategies.
"""

import functools

import numpy as np
import pytest
import torch

from repro.core import adaptive as jad
from repro.core import direct_mc as jdirect
from repro.core import genz as jgenz
from repro.core import integrand as jint
from repro.core import rng as jrng
from repro.kernels import registry as jregistry
from repro.kernels import template as jtemplate
from repro.kernels.mc_eval import multi as jmulti
from repro.service import canonical as jcanonical
from repro_torch.core import adaptive, direct_mc, integrand
from repro_torch.kernels import registry, template
from repro_torch.kernels.mc_eval import multi
from repro_torch.service import canonical

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

INF = np.inf
KEY = jrng.fold_key(3, 7)
# the engine knobs of repro's adaptive benchmark phase (BENCH_10)
ADAPT_KW = dict(seed=0, round_samples=8192, pipeline_waves=False,
                adapt_rounds_per_epoch=1, adapt_max_epochs=3,
                adapt_pilot_samples=2048)


def _port(jfam):
    """The port's family from a raw (not compactified) repro family."""
    return integrand.family_from_numpy(
        jfam.kernel, {k: np.asarray(v) for k, v in jfam.params.items()},
        np.asarray(jfam.domains), jfam.name)


def _grid(n_fn, dim, n_bins, seed, lo=-1.0):
    """(n_fn, dim, n_bins + 1) strictly increasing edges from numpy."""
    r = np.random.default_rng(seed)
    widths = r.uniform(0.05, 2.0, (n_fn, dim, n_bins))
    return (lo + np.concatenate([np.zeros((n_fn, dim, 1)),
                                 np.cumsum(widths, -1)], -1)).astype(np.float32)


def _fitted(jfam, n_bins=8):
    """A repro family's pilot-refined edges (the grid both packages use)."""
    e = jad.initial_edges(np.asarray(jfam.domains), n_bins)
    return jad.refine_edges(e, jad.pilot_weights(jfam, e, KEY, 1024))


@functools.lru_cache(maxsize=None)
def _pairs():
    """(repro, port) adapted families: a Genz corner peak, compactified
    Gaussians over R^2, and a plain harmonic family, sharing one grid."""
    jc = jgenz.corner_peak(5, 2, difficulty=4.0)[0]
    jg = jint.gaussian_family(3, 2, sigma=[0.2, 0.35, 0.3], lo=-INF, hi=INF)
    jh = jint.harmonic_family(4, 2)
    jgc = jg.compactified()
    ec, eg = _fitted(jc, 4), _fitted(jgc, 4)
    return ([jc.adapted(ec), jgc.adapted(eg, epoch=2), jh],
            [_port(jc).adapted(ec), _port(jg).compactified().adapted(eg, epoch=2),
             _port(jh)])


# -- the grid: edges, refits, the map and the pilot ---------------------------

@pytest.mark.parametrize("n_bins", [2, 16])
def test_initial_edges_bit_exact(n_bins):
    box = np.stack([[-1.5, 0.0, 3.0], [2.0, 1e-3, 7.5]], -1)[None].repeat(4, 0)
    box[1] *= 3.0
    want = jad.initial_edges(box, n_bins)
    np.testing.assert_array_equal(adaptive.initial_edges(box, n_bins), want)
    np.testing.assert_array_equal(
        adaptive.initial_edges(torch.from_numpy(box), n_bins), want)
    with pytest.raises(ValueError, match="finite"):
        adaptive.initial_edges(np.asarray([[[0.0, INF]]]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refine_edges_bit_exact(seed):
    edges = _grid(3, 2, 8, seed)
    r = np.random.default_rng(seed + 10)
    weights = r.exponential(1.0, (3, 2, 8)) ** 4     # peaked pilots
    weights[0, 1, :5] = 0.0                            # empty bins
    want = jad.refine_edges(edges, weights)
    got = adaptive.refine_edges(edges, weights)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and np.all(np.diff(got, axis=-1) > 0)
    np.testing.assert_array_equal(adaptive.refine_edges(edges, weights,
                                                        alpha=0.5),
                                  jad.refine_edges(edges, weights, alpha=0.5))


def test_degenerate_pilots_keep_the_grid():
    edges = adaptive.initial_edges(np.asarray([[[0.0, 1.0], [0.0, 2.0]]]), 4)
    for bad in (np.zeros((1, 2, 4)), np.full((1, 2, 4), np.nan),
                np.asarray([[[1.0, np.inf, 1.0, 1.0]] * 2])):
        got = adaptive.refine_edges(edges, bad)
        np.testing.assert_array_equal(got, edges)
        np.testing.assert_array_equal(got, jad.refine_edges(edges, bad))
    with pytest.raises(ValueError, match="do not match"):
        adaptive.refine_edges(edges, np.ones((1, 2, 5)))


@pytest.mark.parametrize("dim,n_bins", [(1, 2), (3, 16)])
def test_apply_map_matches_reference(dim, n_bins):
    edges = _grid(1, dim, n_bins, dim)[0]
    r = np.random.default_rng(5)
    u = r.integers(0, 1 << 24, (2000, dim)).astype(np.float32) * 2.0**-24
    u[:3] = np.asarray([0.0, 0.5, 1 - 2.0**-24], np.float32)[:, None]
    x, jac = adaptive.apply_map(torch.from_numpy(u), torch.from_numpy(edges))
    jx, jj = jad.apply_map(u, edges)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(jac.numpy(), np.asarray(jj), rtol=1e-4)
    np.testing.assert_array_equal(x.numpy()[0], edges[:, 0])   # u = 0 -> lo


@pytest.mark.parametrize("which", ["corner", "gaussian_compact"])
def test_pilot_weights_match_reference(which):
    if which == "corner":
        jfam = jgenz.corner_peak(4, 3, difficulty=4.0)[0]
        fam = _port(jfam)
    else:
        jraw = jint.gaussian_family(3, 2, sigma=[0.2, 0.3, 0.5], lo=-INF, hi=INF)
        jfam, fam = jraw.compactified(), _port(jraw).compactified()
    edges = _grid(jfam.n_fn, jfam.dim, 8, 4, lo=0.0)
    edges = (edges / edges[..., -1:]).astype(np.float32)    # span [0, 1]
    want = jad.pilot_weights(jfam, edges, KEY, 1024)
    got = adaptive.pilot_weights(fam, edges, KEY, 1024)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-30)
    np.testing.assert_array_equal(got, adaptive.pilot_weights(fam, edges, KEY,
                                                              1024))


# -- adapted families, packing and the plan ---------------------------------

def test_adapted_family_names_hash_and_views():
    (jc, jg, _), (c, g, _) = _pairs()
    for j, p in ((jc, c), (jg, g)):
        assert p.name == j.name and p.adapt_bins == j.adapt_bins
        np.testing.assert_array_equal(p.domains.numpy(), np.asarray(j.domains))
        np.testing.assert_array_equal(p.adapt_inner().domains.numpy(),
                                      np.asarray(j.adapt_inner().domains))
        assert canonical.family_hash(p) == jcanonical.family_hash(j)
    assert g.compact and g.inner().params.keys() == jg.inner().params.keys()
    with pytest.raises(ValueError, match="never nest"):
        c.adapted(np.asarray(c.params["grid"]))
    with pytest.raises(ValueError, match="finite box"):
        _port(jint.gaussian_family(2, 2, lo=-INF, hi=INF)).adapted(
            _grid(2, 2, 4, 0))
    with pytest.raises(ValueError, match="sweep the template"):
        c.swept_over({"a": np.ones((3, 2), np.float32)})


@pytest.mark.parametrize("index", [0, 1])
def test_adapted_packed_rows_bit_exact(index):
    jfams, fams = _pairs()
    jf, f = jfams[index], fams[index]
    form, jform = registry.form(f.kernel), jregistry.form(jf.kernel)
    _, packed = template.body_and_packed(form, f)
    _, jpacked = jtemplate.body_and_packed(jform, jf)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    assert template.packed_cols(form, f) == jtemplate.packed_cols(jform, jf)
    np.testing.assert_array_equal(template.adapt_grid_cols(f).numpy(),
                                  np.asarray(jtemplate.adapt_grid_cols(jf)))
    assert template.adapt_col(form, f) == (form.n_cols(f.dim), f.adapt_bins)
    assert registry.lookup(f.kernel, dim=f.dim, compactified=f.compact,
                           adapted=True) is not None


def test_plan_fuses_adapted_as_reference():
    jfams, fams = _pairs()
    jplan = jmulti.plan_spec(jint.MultiFunctionSpec.from_families(jfams))
    plan = multi.plan_spec(integrand.MultiFunctionSpec.from_families(fams))
    assert plan.unfused == jplan.unfused == ()
    assert plan.n_launches == jplan.n_launches == 1
    (b,), (jb,) = plan.buckets, jplan.buckets
    assert b.name == jb.name
    for name in ("packed", "lo", "hi", "fn_ids"):
        np.testing.assert_array_equal(getattr(b, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    # blocks: the corner peak, the compactified Gaussians, the harmonics
    assert b.block_adapt.tolist() == [[2, 1, -1], [4, 4, 0]]
    assert b.block_tcols.tolist() == [-1, 1 + 2 * 5, -1]
    assert b.block_meta.tolist() == [b.block_forms.tolist(),
                                     b.block_tcols.tolist(),
                                     *b.block_adapt.tolist()]


# the MC case here, the Sobol one in test_torch_adaptive_sobol.py (each a
# ~45 s interpret-mode run of the reference's kernel under the suite's load)
@pytest.mark.parametrize("sampler", ["mc"])
def test_adapted_sums_vs_reference_fused_interpret(sampler):
    check_adapted_sums_vs_reference_fused_interpret(sampler)


def check_adapted_sums_vs_reference_fused_interpret(sampler):
    """One bucket of adapted, adapted-and-compactified and plain families,
    at a window crossing 2^32: the port's fused plain version against
    repro's fused kernel in interpret mode, and the port's chunked path."""
    jfams, fams = _pairs()
    rtol, atol = (5e-5, 5e-3) if sampler == "mc" else (1e-4, 1e-2)
    n, off = 2048 + 37, 2**32 - 1000
    jplan = jmulti.plan_spec(jint.MultiFunctionSpec.from_families(jfams),
                             sampler=sampler)
    plan = multi.plan_spec(integrand.MultiFunctionSpec.from_families(fams),
                           sampler=sampler)
    want = jmulti.eval_plan(jplan, n, KEY, sample_offset=off)
    got = multi.eval_plan(plan, n, KEY, sample_offset=off)
    for i in range(len(fams)):
        for a, w in ((got[i].s1, want[i].s1), (got[i].s2, want[i].s2)):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=rtol,
                                       atol=atol)
    if sampler == "mc":
        offs = integrand.MultiFunctionSpec.from_families(fams).offsets()
        for i, fam in enumerate(fams):
            chunked = direct_mc.family_sums(fam, n, KEY, fn_offset=offs[i],
                                            sample_offset=off, chunk=1024)
            np.testing.assert_allclose(chunked.s1.numpy(),
                                       np.asarray(want[i].s1),
                                       rtol=rtol, atol=atol)


def test_chunked_adapted_sums_vs_reference_chunked():
    jfams, fams = _pairs()
    for jf, f in zip(jfams[:2], fams[:2]):
        kw = dict(fn_offset=3, sample_offset=77, chunk=1024)
        want = jdirect.family_sums(jf, 3000, KEY, **kw)
        got = direct_mc.family_sums(f, 3000, KEY, **kw)
        for a, w in ((got.s1, want.s1), (got.s2, want.s2)):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=5e-5,
                                       atol=5e-3)


def test_adapted_grid_from_reference_record_packs_equal_rows():
    """Edges as a reference grid record holds them (numpy f32 from
    refine_edges) give the port the reference's packed rows."""
    jc = jgenz.corner_peak(3, 3, difficulty=4.0)[0]
    edges = _fitted(jc, 16)
    f = _port(jc).adapted(edges, epoch=3)
    jf = jc.adapted(edges, epoch=3)
    assert f.name == jf.name
    form = registry.form(f.kernel)
    np.testing.assert_array_equal(template.body_and_packed(form, f)[1].numpy(),
                                  np.asarray(jtemplate.body_and_packed(
                                      jregistry.form(jf.kernel), jf)[1]))
