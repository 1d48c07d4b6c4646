"""The port's kernel layer against repro's: packing and plans bit for bit,
the fused kernel's plain version against repro's Pallas kernel (run in
interpret mode, as repro's own tests run it on the CPU), and sums, means
and stderrs within repro's own MC bound (rtol=5e-5, atol=5e-3,
tests/kernels/test_mc_eval.py).

All tests that reach repro's kernels live in this one file so that the
registry's contract checks and the interpret-mode compiles are paid once.
"""

import math

import numpy as np
import pytest
import torch

from repro.core import direct_mc as jdirect
from repro.core import genz as jgenz
from repro.core import integrand as jint
from repro.core import rng as jrng
from repro.core.multifunctions import ZMCMultiFunctions as JZMC
from repro.kernels import registry as jregistry
from repro.kernels import template as jtemplate
from repro.kernels.mc_eval import multi as jmulti
from repro_torch.core import direct_mc, genz, integrand
from repro_torch.core.multifunctions import ZMCMultiFunctions
from repro_torch.kernels import registry, template
from repro_torch.kernels.mc_eval import multi

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

RTOL, ATOL = 5e-5, 5e-3
FORMS = ["mc_eval_harmonic", "mc_eval_abs_sum", "mc_eval_gaussian",
         "mc_eval_genz_osc", "mc_eval_genz_corner"]


def _port(jfam, fn=None):
    return integrand.family_from_numpy(
        jfam.kernel, {k: np.asarray(v) for k, v in jfam.params.items()},
        np.asarray(jfam.domains), jfam.name, fn=fn)


def _port_spec(jspec, fns=None):
    fns = fns or {}
    return integrand.MultiFunctionSpec.from_families(
        [_port(f, fns.get(i)) for i, f in enumerate(jspec.families)])


def _jfamily(form: str, n: int, dim: int):
    if form == "mc_eval_harmonic":
        return jint.harmonic_family(n, dim)
    if form == "mc_eval_abs_sum":
        return jint.abs_sum_family(n, dim, np.linspace(0.5, 2.0, n),
                                   sign_last=-1.0)
    if form == "mc_eval_gaussian":
        return jint.gaussian_family(n, dim)
    if form == "mc_eval_genz_osc":
        return jgenz.oscillatory(n, dim)[0]
    return jgenz.corner_peak(n, dim)[0]


def _rows(sums, n_fn=None):
    s1 = np.asarray(sums.s1 if not isinstance(sums.s1, torch.Tensor)
                    else sums.s1.numpy())
    s2 = np.asarray(sums.s2 if not isinstance(sums.s2, torch.Tensor)
                    else sums.s2.numpy())
    return np.stack([s1, s2], -1)


def test_register_bare_callable():
    """``registry.register`` as repro's: the decorated callable comes back
    unchanged and ``get`` reaches it; a second registration under the
    same name raises and keeps the first."""
    name = "test_bare_kernel"

    def fn(x):
        return x + 1

    try:
        assert registry.register(name)(fn) is fn
        assert registry.get(name) is fn
        with pytest.raises(ValueError, match="already registered"):
            registry.register(name)(lambda x: x)
        assert registry.get(name) is fn
        with pytest.raises(ValueError, match="already registered"):
            registry.register("mc_eval_harmonic")(fn)
    finally:
        registry._REGISTRY.pop(name, None)


# -- packing and scalars, bit for bit -----------------------------------------

def test_form_ids_and_capabilities():
    assert [registry.form(n).form_id for n in FORMS] == [0, 1, 2, 3, 4]
    for f in registry.forms():
        jf = jregistry.form(f.name)
        assert f.samplers == jf.samplers == ("mc", "sobol")
        # the compactification, sweep and grid stages are all ported
        assert f.supports_compactified == jf.supports_compactified
        assert f.supports_adapted == jf.supports_adapted
        for dim in (1, 3, 8):
            assert f.sweep_cols(dim) == jf.sweep_cols(dim)
        assert f.n_cols(3) == jf.n_cols(3)
    assert registry.names() == sorted(FORMS + [f + "@sobol" for f in FORMS])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dim", [1, 3])
def test_pack_and_body_and_packed_bit_exact(form, dim):
    jfam = _jfamily(form, 5, dim)
    fam = _port(jfam)
    jform, pform = jregistry.form(form), registry.form(form)
    want = np.asarray(jform.pack_params(jfam))
    np.testing.assert_array_equal(pform.pack_params(fam).numpy(), want)
    _, packed = template.body_and_packed(pform, fam)
    _, jpacked = jtemplate.body_and_packed(jform, jfam)
    assert packed.dtype == torch.float32
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    assert template.packed_cols(pform, fam) == jtemplate.packed_cols(jform, jfam)


@pytest.mark.parametrize("key,offset,n", [
    ((1, 2), 0, 4096), ((2**32 - 1, 7), 2**32 - 5, 10**6), ((0, 0), 12345, 1)])
def test_pack_scalars_bit_exact(key, offset, n):
    want = np.asarray(jtemplate.pack_scalars(key, offset, n))
    np.testing.assert_array_equal(template.pack_scalars(key, offset, n).numpy(),
                                  want.astype(np.int64))


# -- the bucket plan, bit for bit ---------------------------------------------

def _mixed_jspec():
    return jint.MultiFunctionSpec.from_families([
        jint.harmonic_family(20, 4),
        jgenz.product_peak(3, 2)[0],           # no kernel: stays unfused
        jint.harmonic_family(7, 2),
        jint.abs_sum_family(5, 2, np.ones(5)),
        jint.abs_sum_family(17, 3, np.linspace(0.5, 2, 17), sign_last=-1.0),
        jint.gaussian_family(4, 4),
        jgenz.oscillatory(5, 3)[0],
        jgenz.corner_peak(4, 4)[0],
        jint.gaussian_family(3, 1),
    ])


@pytest.mark.parametrize("fn_offsets", [None, [0, 40, 80, 120, 500, 600, 700,
                                               2**24 - 20, 2**24 + 3]])
def test_plan_spec_bit_exact(fn_offsets):
    jspec = _mixed_jspec()
    spec = _port_spec(jspec, {1: genz.product_peak_fn})
    jplan = jmulti.plan_spec(jspec, fn_offsets=fn_offsets)
    plan = multi.plan_spec(spec, fn_offsets=fn_offsets)
    assert plan.unfused == jplan.unfused == (1,)
    assert plan.n_launches == jplan.n_launches == 4
    for b, jb in zip(plan.buckets, jplan.buckets):
        assert b.dim == jb.dim and b.name == jb.name
        assert [(s.family_index, s.row_start, s.n_fn) for s in b.slices] == \
            [(s.family_index, s.row_start, s.n_fn) for s in jb.slices]
        # repro's per-block encoding: index into the bucket's distinct
        # bodies in order of first use, None when there is one
        forms = b.block_forms.tolist()
        distinct = list(dict.fromkeys(forms))
        assert len(distinct) == len(jb.bodies)
        if jb.form_ids is None:
            assert len(distinct) == 1
        else:
            assert [distinct.index(f) for f in forms] == \
                np.asarray(jb.form_ids).tolist()
        np.testing.assert_array_equal(b.fn_ids.numpy(), np.asarray(jb.fn_ids))
        for name in ("packed", "lo", "hi"):
            np.testing.assert_array_equal(getattr(b, name).numpy(),
                                          np.asarray(getattr(jb, name)))
        # kernel form ids: the form of each block's family
        for s in b.slices:
            fid = registry.form(spec.families[s.family_index].kernel).form_id
            blocks = b.block_forms[s.row_start // 16:
                                   (s.row_start + s.n_fn + 15) // 16]
            assert blocks.tolist() == [fid] * len(blocks)


# -- fused_mc_plain against repro's Pallas kernel (interpret mode) ------------

N_MIXED = jtemplate.S_BLK + 777              # two blocks, the tail masked
OFFSET_MIXED = 2**32 - 3000                  # exercises the c0 wrap


@pytest.fixture(scope="module")
def mixed_bucket():
    """One bucket holding all five forms, through both packages (dim 1:
    the interpret-mode compile grows with dim; the slice test below covers
    dims 2-4)."""
    jspec = jint.MultiFunctionSpec.from_families(
        [_jfamily(f, n, 1) for f, n in zip(FORMS, (9, 16, 7, 5, 6))])
    jplan = jmulti.plan_spec(jspec)
    plan = multi.plan_spec(_port_spec(jspec))
    (jb,), (b,) = jplan.buckets, plan.buckets
    key = jrng.fold_key(3, 1)
    nsb = math.ceil(N_MIXED / jtemplate.S_BLK)
    want = np.asarray(jtemplate.fused_mc_pallas(
        jtemplate.pack_scalars(key, OFFSET_MIXED, N_MIXED), jb.fn_ids,
        jb.packed, jb.lo, jb.hi, form_ids=jb.form_ids, dim=jb.dim,
        n_sample_blocks=nsb, bodies=jb.bodies, sampler="mc", interpret=True,
        name=jb.name))[0]
    got = template.fused_mc_plain(
        template.pack_scalars(key, OFFSET_MIXED, N_MIXED), b.fn_ids, b.packed,
        b.lo, b.hi, b.block_forms, dim=b.dim, n_sample_blocks=nsb)[0].numpy()
    return b, key, want, got


@pytest.mark.parametrize("index", range(5), ids=FORMS)
def test_fused_plain_vs_pallas_per_body(mixed_bucket, index):
    b, key, want, got = mixed_bucket
    s = b.slices[index]
    rows = slice(s.row_start, s.row_start + s.n_fn)
    assert np.isfinite(got[rows]).all()
    np.testing.assert_allclose(got[rows], want[rows], rtol=RTOL, atol=ATOL)


def test_fused_plain_vs_pallas_mixed_bucket(mixed_bucket):
    b, key, want, got = mixed_bucket
    assert len(set(b.block_forms.tolist())) == 5
    real = np.concatenate([np.arange(s.row_start, s.row_start + s.n_fn)
                           for s in b.slices])
    np.testing.assert_allclose(got[real], want[real], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("index", range(5), ids=FORMS)
def test_single_form_launch_matches_mixed_rows(mixed_bucket, index):
    """A family's own launch draws the same counters as its rows in the
    mixed bucket.  On the CPU the sums agree within the MC bound only:
    PyTorch picks its reduction order by tensor shape.  (On the card the
    kernel's rows are bit-identical; see test_torch_cuda.py.)"""
    b, key, _, got = mixed_bucket
    s = b.slices[index]
    n_pad = math.ceil(s.n_fn / 16) * 16
    rows = slice(s.row_start, s.row_start + n_pad)
    one = template.fused_mc_plain(
        template.pack_scalars(key, OFFSET_MIXED, N_MIXED), b.fn_ids[rows],
        b.packed[rows].contiguous(), b.lo[rows].contiguous(),
        b.hi[rows].contiguous(), b.block_forms[s.row_start // 16:
                                               (s.row_start + n_pad) // 16],
        dim=b.dim, n_sample_blocks=math.ceil(N_MIXED / template.S_BLK))[0]
    np.testing.assert_allclose(one.numpy()[:s.n_fn],
                               got[s.row_start:s.row_start + s.n_fn],
                               rtol=RTOL, atol=ATOL)


# -- family_sums: chunked and through the kernel ------------------------------

@pytest.mark.parametrize("form", FORMS)
def test_family_sums_chunked_and_kernel_vs_repro(form):
    jfam = _jfamily(form, 6, 3)
    fam = _port(jfam)
    key = jrng.fold_key(8, 2)
    kw = dict(fn_offset=7, sample_offset=2**32 - 1000, chunk=1024)
    want = jdirect.family_sums(jfam, 2500, key, **kw)
    got = direct_mc.family_sums(fam, 2500, key, **kw)
    np.testing.assert_allclose(_rows(got), _rows(want), rtol=RTOL, atol=ATOL)
    blocked = direct_mc.family_sums(fam, 2500, key, fn_chunk=4, **kw)
    np.testing.assert_allclose(_rows(blocked), _rows(want), rtol=RTOL, atol=ATOL)
    kern = direct_mc.family_sums(fam, 2500, key, use_kernel=True,
                                 fn_offset=7, sample_offset=2**32 - 1000)
    np.testing.assert_allclose(_rows(kern), _rows(want), rtol=RTOL, atol=ATOL)


# -- the slice as a whole ------------------------------------------------------

@pytest.fixture(scope="module")
def slice_results():
    """ZMCMultiFunctions on a mixed spec (dims 2-4, all five forms, one
    family without a kernel), two trials, through both packages.  repro
    runs its chunked engine: the same counters as its kernel, whose sums
    repro's own tests hold to the chunked ones, and the Pallas comparison
    above covers the kernel."""
    jspec = _mixed_jspec()
    jspec = jint.MultiFunctionSpec.from_families(    # abs_sum 2d goes: one
        [f for i, f in enumerate(jspec.families)       # fused family per
         if f.dim > 1 and i != 3])                     # (form, dim) is enough
    spec = _port_spec(jspec, {1: genz.product_peak_fn})
    n = 2048 + 301                            # two blocks, the tail masked
    want = JZMC(jspec, n_samples=n, seed=4).evaluate(num_trials=2)
    template.reset_launch_count()
    got = ZMCMultiFunctions(spec, n_samples=n, seed=4, use_kernel=True,
                            device="cpu").evaluate(num_trials=2)
    launches = template.launch_count()
    chunked = ZMCMultiFunctions(spec, n_samples=n, seed=4,
                                device="cpu").evaluate(num_trials=2)
    return want, got, chunked, launches


def test_evaluate_kernel_path_vs_repro(slice_results):
    want, got, _, launches = slice_results
    assert launches == 3 * 2                  # 3 dim buckets x 2 trials
    assert got.names == want.names and got.means.shape == want.means.shape
    np.testing.assert_allclose(got.means, want.means, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.stderrs, want.stderrs, rtol=RTOL, atol=ATOL)


def test_evaluate_chunked_path_vs_repro(slice_results):
    want, _, chunked, _ = slice_results
    np.testing.assert_allclose(chunked.means, want.means, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(chunked.stderrs, want.stderrs, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(chunked.trial_std, want.trial_std, rtol=1e-3,
                               atol=ATOL)


def test_checkpoint_tag_matches_repro():
    jspec = _mixed_jspec()
    spec = _port_spec(jspec, {1: genz.product_peak_fn})
    assert (ZMCMultiFunctions(spec, n_samples=777, seed=5, device="cpu")._ckpt_tag()
            == JZMC(jspec, n_samples=777, seed=5)._ckpt_tag())
