"""The compactification stage against repro's: transform metadata, packed
columns and rows bit for bit, the map within f32 tolerance, the bucket
plan fusing finite and compactified families as repro's does, and sums
and estimates of compactified families within repro's MC bound
(rtol=5e-5, atol=5e-3) on the chunked path and through the fused
kernel's plain version.
"""

import numpy as np
import pytest
import torch

from repro.core import direct_mc as jdirect
from repro.core import domains as jdomains
from repro.core import genz as jgenz
from repro.core import integrand as jint
from repro.core import rng as jrng
from repro.core.multifunctions import ZMCMultiFunctions as JZMC
from repro.kernels import registry as jregistry
from repro.kernels import template as jtemplate
from repro.kernels.mc_eval import multi as jmulti
from repro_torch.core import direct_mc, domains, integrand
from repro_torch.core.multifunctions import ZMCMultiFunctions
from repro_torch.kernels import registry, template
from repro_torch.kernels.mc_eval import multi

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

RTOL, ATOL = 5e-5, 5e-3
INF = np.inf


def _port(jfam):
    """The port's family from a raw (not yet compactified) repro family."""
    return integrand.family_from_numpy(
        jfam.kernel, {k: np.asarray(v) for k, v in jfam.params.items()},
        np.asarray(jfam.domains), jfam.name)


def _box(lo, hi, n=3):
    return np.broadcast_to(np.stack([np.asarray(lo, np.float64),
                                     np.asarray(hi, np.float64)], -1),
                           (n, len(lo), 2)).copy()


BOXES = {
    "R^2": _box([-INF, -INF], [INF, INF]),
    "orthant^3": _box([0.0, 0.0, 0.0], [INF, INF, INF]),
    "mixed^3": _box([-INF, 1.5, -2.0], [0.5, INF, 3.0]),
    "finite^1": _box([-1.0], [2.0]),
}


@pytest.mark.parametrize("name", sorted(BOXES))
def test_transform_params_bit_exact(name):
    box = BOXES[name]
    for got, want in zip(domains.transform_params(box),
                         jdomains.transform_params(box)):
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))
    assert domains.transform_params(torch.from_numpy(box))[0].tolist() == \
        np.asarray(jdomains.transform_params(box)[0]).tolist()


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_apply_transform_matches_reference(kind):
    r = np.random.default_rng(kind)
    u = r.uniform(0.0, 1.0, 4000).astype(np.float32)
    u[:6] = [0.0, 1e-9, 1e-7, 0.5, 1 - 1e-7, 0.99999994]   # the clamp edges
    shift = r.uniform(-2.0, 2.0, 4000).astype(np.float32)
    kinds = np.full(4000, kind, np.int32)
    x, jac = domains.apply_transform(torch.from_numpy(u), torch.from_numpy(kinds),
                                     torch.from_numpy(shift))
    jx, jj = jdomains.apply_transform(u, kinds, shift)
    # f32 transcendentals: libm's and XLA's tan/cos may differ by an ulp,
    # which the pole's derivative turns into a relative 1e-6
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(jac.numpy(), np.asarray(jj), rtol=2e-6, atol=1e-6)
    if kind == 0:
        np.testing.assert_array_equal(x.numpy(), u)
        assert (jac.numpy() == 1.0).all()


def _jfamilies():
    return [
        jint.gaussian_family(5, 2, lo=-INF, hi=INF),
        jint.gaussian_family(7, 3, lo=0.0, hi=INF),
        jint.harmonic_family(6, 2),
        jint.abs_sum_family(4, 3, np.linspace(0.5, 2, 4)),
        jint.IntegrandFamily(                 # a half-line, a finite axis
            fn=jint.gaussian_family(3, 2).fn,
            params={"sigma": np.linspace(0.5, 1.5, 3).astype(np.float32)},
            domains=_box([-INF, -1.0], [1.0, 2.0]), name="gauss_mixed",
            kernel="mc_eval_gaussian"),
        jgenz.corner_peak(4, 2)[0],
        jgenz.product_peak(3, 2)[0],          # no kernel: stays unfused
    ]


def _pair():
    jfams = _jfamilies()
    fams = []
    from repro_torch.core import genz
    for f in jfams:
        fn = genz.product_peak_fn if f.kernel is None else None
        fams.append(integrand.family_from_numpy(
            f.kernel, {k: np.asarray(v) for k, v in f.params.items()},
            np.asarray(f.domains), f.name, fn=fn))
    return jfams, fams


@pytest.mark.parametrize("index", [0, 1, 4])
def test_compactified_family_and_packing_bit_exact(index):
    jfams, fams = _pair()
    jc, c = jfams[index].compactified(), fams[index].compactified()
    assert c.compact and jc.compact and c.name == jc.name
    assert c.inner().params.keys() == jc.inner().params.keys()
    np.testing.assert_array_equal(c.domains.numpy(), np.asarray(jc.domains))
    for k in ("kind", "shift"):
        np.testing.assert_array_equal(c.params["aux"][k].numpy(),
                                      np.asarray(jc.params["aux"][k]))
    np.testing.assert_array_equal(template.transform_cols(c).numpy(),
                                  np.asarray(jtemplate.transform_cols(jc)))
    form, jform = registry.form(c.kernel), jregistry.form(jc.kernel)
    _, packed = template.body_and_packed(form, c)
    _, jpacked = jtemplate.body_and_packed(jform, jc)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    assert template.packed_cols(form, c) == jtemplate.packed_cols(jform, jc)
    assert template.transform_col(form, c) == jform.n_cols(c.dim)
    assert registry.lookup(c.kernel, dim=c.dim, compactified=True) is not None


def test_plan_spec_fuses_compactified_as_reference():
    jfams, fams = _pair()
    jspec = jint.MultiFunctionSpec.from_families([f.compactified() for f in jfams])
    spec = integrand.MultiFunctionSpec.from_families([f.compactified() for f in fams])
    jplan, plan = jmulti.plan_spec(jspec), multi.plan_spec(spec)
    assert plan.unfused == jplan.unfused == (6,)
    assert plan.n_launches == jplan.n_launches == 2
    for b, jb in zip(plan.buckets, jplan.buckets):
        assert b.dim == jb.dim and b.name == jb.name
        assert [(s.family_index, s.row_start, s.n_fn) for s in b.slices] == \
            [(s.family_index, s.row_start, s.n_fn) for s in jb.slices]
        for name in ("packed", "lo", "hi", "fn_ids"):
            np.testing.assert_array_equal(getattr(b, name).numpy(),
                                          np.asarray(getattr(jb, name)))
        # one kernel form per block; the transform columns' start on the
        # compactified blocks, -1 on the finite ones
        for s in b.slices:
            fam = spec.families[s.family_index]
            blocks = slice(s.row_start // 16, (s.row_start + s.n_fn + 15) // 16)
            want = registry.form(fam.kernel).n_cols(fam.dim) if fam.compact else -1
            assert set(b.block_tcols[blocks].tolist()) == {want}


@pytest.mark.parametrize("index", [0, 1, 4])
def test_compactified_sums_chunked_and_kernel_vs_repro(index):
    jfams, fams = _pair()
    jc, c = jfams[index].compactified(), fams[index].compactified()
    key = jrng.fold_key(5, 1)
    kw = dict(fn_offset=3, sample_offset=2**32 - 700, chunk=1024)
    want = jdirect.family_sums(jc, 2500, key, **kw)
    got = direct_mc.family_sums(c, 2500, key, **kw)
    kern = direct_mc.family_sums(c, 2500, key, use_kernel=True, fn_offset=3,
                                 sample_offset=2**32 - 700)
    for sums in (got, kern):
        for a, b in ((sums.s1, want.s1), (sums.s2, want.s2)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)


def test_evaluate_compactified_spec_vs_repro():
    """ZMCMultiFunctions compactifies infinite boxes as repro's does: two
    trials of the mixed spec through the port's kernel path against
    repro's chunked engine, and the checkpoint tag over the compactified
    names."""
    jfams, fams = _pair()
    n = 2048 + 301
    want = JZMC(jfams, n_samples=n, seed=6).evaluate(num_trials=2)
    template.reset_launch_count()
    zmc = ZMCMultiFunctions(fams, n_samples=n, seed=6, use_kernel=True,
                            device="cpu")
    got = zmc.evaluate(num_trials=2)
    assert template.launch_count() == 2 * 2            # 2 dim buckets x 2 trials
    assert got.names == want.names
    np.testing.assert_allclose(got.means, want.means, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.stderrs, want.stderrs, rtol=RTOL, atol=ATOL)
    assert zmc._ckpt_tag() == JZMC(jfams, n_samples=n, seed=6)._ckpt_tag()


def test_family_from_numpy_of_a_compactified_family():
    """A repro family already compactified converts with compact=True and
    evaluates as the port's own compactification of the raw family."""
    jc = jint.gaussian_family(4, 2, lo=0.0, hi=INF).compactified()
    params = {"inner": {k: np.asarray(v) for k, v in jc.params["inner"].items()},
              "aux": {k: np.asarray(v) for k, v in jc.params["aux"].items()}}
    fam = integrand.family_from_numpy(jc.kernel, params, np.asarray(jc.domains),
                                      jc.name, compact=True)
    own = _port(jint.gaussian_family(4, 2, lo=0.0, hi=INF)).compactified()
    assert fam.params["aux"]["kind"].dtype == torch.int32
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0.0, 1.0, (4, 64, 2)).astype(np.float32))
    torch.testing.assert_close(fam.eval_batch(x), own.eval_batch(x))
