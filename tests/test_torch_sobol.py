"""The Sobol (randomised QMC) sampler against repro's: direction vectors,
points, shifts and uniforms bit for bit (indices across 2^32); chunked
Sobol sums and the fused kernel's plain version within repro's Sobol
bound (rtol=1e-4, atol=1e-2, ``tests/kernels/test_mc_eval.py``); the
plain version's fold against a float64 sum at 10^6 samples; the bucket plan and the ``MAX_DIM`` rule (a dim-9 family degrades to MC) as
repro's; ``evaluate``, ``evaluate_resumable`` and Sobol service requests
against repro's.
"""

import math

import numpy as np
import pytest
import torch

from repro.core import direct_mc as jdirect
from repro.core import genz as jgenz
from repro.core import integrand as jint
from repro.core import rng as jrng
from repro.core import sobol as jsobol
from repro.core.multifunctions import ZMCMultiFunctions as JZMC
from repro.kernels import template as jtemplate
from repro.kernels.mc_eval import multi as jmulti
from repro.service import IntegrationEngine as JEngine
from repro.service import IntegrationRequest as JRequest
from repro_torch.core import direct_mc, integrand, sobol
from repro_torch.core.domains import affine_from_unit
from repro_torch.core.multifunctions import ZMCMultiFunctions
from repro_torch.kernels import registry, template
from repro_torch.kernels.mc_eval import multi, ops, sobol_kernel
from repro_torch.service import IntegrationEngine, IntegrationRequest

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-2          # repro's Sobol kernel-vs-engine bound
INF = np.inf
# indices on both sides of the u32 wrap
INDICES = np.concatenate([np.arange(3000), 2**32 - 1500 + np.arange(3000)]) % 2**32


def _port(jfam, **kw):
    return integrand.family_from_numpy(
        jfam.kernel, {k: np.asarray(v) for k, v in jfam.params.items()},
        np.asarray(jfam.domains), jfam.name, **kw)


@pytest.mark.parametrize("dim", range(1, 9))
def test_direction_vectors_bit_exact(dim):
    got, want = sobol.direction_vectors(dim), jsobol.direction_vectors(dim)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_direction_vectors_above_max_dim_raise():
    assert sobol.MAX_DIM == jsobol.MAX_DIM == 8
    with pytest.raises(ValueError, match="dim <= 8"):
        sobol.direction_vectors(9)


@pytest.mark.parametrize("dim", [1, 3, 8])
def test_sobol_bits_bit_exact(dim):
    idx = INDICES.astype(np.uint32)
    want = np.asarray(jsobol.sobol_bits(idx, dim)).astype(np.int64)
    got = sobol.sobol_bits(INDICES, dim)
    assert got.dtype == torch.int64 and tuple(got.shape) == (len(idx), dim)
    np.testing.assert_array_equal(got.numpy(), want)


def test_shifts_and_uniforms_bit_exact():
    key = jrng.fold_key(7, 2)
    fn_ids = np.array([0, 1, 77, 2**24 - 1], np.uint32)
    want = np.asarray(jsobol.shifts_for(*key, fn_ids, 5)).astype(np.int64)
    np.testing.assert_array_equal(sobol.shifts_for(*key, fn_ids, 5).numpy(), want)
    idx = INDICES[::7].astype(np.uint32)
    want = np.asarray(jsobol.sobol_uniforms_for(*key, fn_ids, idx, 5))
    got = sobol.sobol_uniforms_for(*key, torch.from_numpy(fn_ids.astype(np.int64)),
                                   idx, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def _jfamilies():
    return [
        jint.harmonic_family(6, 3),
        jint.gaussian_family(5, 2, lo=-INF, hi=INF),
        jgenz.corner_peak(4, 4)[0],
    ]


@pytest.mark.parametrize("index", [0, 1, 2])
def test_chunked_and_kernel_sobol_sums_vs_reference(index):
    jf = _jfamilies()[index].compactified()
    f = _port(_jfamilies()[index]).compactified()
    key = jrng.fold_key(5, 1)
    kw = dict(fn_offset=3, sample_offset=2**32 - 700, sampler="sobol")
    want = jdirect.family_sums(jf, 2500, key, chunk=1024, **kw)
    got = direct_mc.family_sums(f, 2500, key, chunk=1024, **kw)
    kern = direct_mc.family_sums(f, 2500, key, use_kernel=True, **kw)
    for sums in (got, kern):
        for a, b in ((sums.s1, want.s1), (sums.s2, want.s2)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)


def test_dim9_sobol_family_degrades_to_mc():
    """repro's _sums_with_ids rule: beyond the Joe-Kuo table the Sobol
    request draws MC, on the chunked path and through use_kernel alike;
    the fused plan leaves the family unfused."""
    jf = jint.harmonic_family(3, 9)
    f = _port(jf)
    key = jrng.fold_key(2, 2)
    for use_kernel in (False, True):
        mc = direct_mc.family_sums(f, 1500, key, chunk=512, use_kernel=use_kernel)
        s = direct_mc.family_sums(f, 1500, key, chunk=512, sampler="sobol",
                                  use_kernel=use_kernel)
        assert torch.equal(s.s1, mc.s1) and torch.equal(s.s2, mc.s2)
    want = jdirect.family_sums(jf, 1500, key, chunk=512, sampler="sobol")
    np.testing.assert_allclose(mc.s1.numpy(), np.asarray(want.s1), rtol=RTOL,
                               atol=ATOL)
    spec = integrand.MultiFunctionSpec.from_families([f, _port(jint.harmonic_family(2, 8))])
    plan = multi.plan_spec(spec, sampler="sobol")
    assert plan.unfused == (0,) and [b.dim for b in plan.buckets] == [8]
    assert registry.lookup(f.kernel, dim=9, sampler="sobol") is None


def test_function_blocked_sums_keep_the_sampler():
    """fn_chunk keeps repro's sampler rule: its function blocks take the
    chunked MC path whatever the sampler, so a blocked Sobol request
    returns repro's blocked sums, which are the MC ones."""
    jf = jint.harmonic_family(7, 2)
    f = _port(jf)
    key = jrng.fold_key(1, 9)
    want = jdirect.family_sums(jf, 3000, key, sampler="sobol", fn_chunk=3)
    blocked = direct_mc.family_sums(f, 3000, key, sampler="sobol", fn_chunk=3)
    mc = direct_mc.family_sums(f, 3000, key, fn_chunk=3)
    assert torch.equal(blocked.s1, mc.s1) and torch.equal(blocked.s2, mc.s2)
    for a, b in ((blocked.s1, want.s1), (blocked.s2, want.s2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-5, atol=5e-3)
    whole = direct_mc.family_sums(f, 3000, key, sampler="sobol")
    assert not torch.allclose(blocked.s1, whole.s1, rtol=1e-3, atol=1e-3)


def _jbucket_spec():
    return [
        jint.gaussian_family(9, 2, lo=-INF, hi=INF),
        jint.harmonic_family(20, 2),
    ]


@pytest.fixture(scope="module")
def sobol_launches():
    """One R = 2 Sobol launch of a mixed dim-2 bucket with compactified
    rows through both packages (repro's Pallas kernel in interpret mode)."""
    jspec = jint.MultiFunctionSpec.from_families(
        [f.compactified() for f in _jbucket_spec()])
    spec = integrand.MultiFunctionSpec.from_families(
        [_port(f).compactified() for f in _jbucket_spec()])
    (jb,) = jmulti.plan_spec(jspec, sampler="sobol").buckets
    plan = multi.plan_spec(spec, sampler="sobol")
    (b,) = plan.buckets
    n, r = 2048 + 301, 2
    starts = {0: (2**32 - 1000) // n, 1: 3}
    key = jrng.fold_key(13, 4)
    nsb = math.ceil(n / jtemplate.S_BLK)
    want = np.asarray(jtemplate.fused_mc_pallas(
        jtemplate.pack_scalars(key, 0, n, round_stride=n), jb.fn_ids,
        jb.packed, jb.lo, jb.hi, form_ids=jb.form_ids,
        round_base=jmulti._round_base_for(jb, starts, n),
        dirvecs=np.asarray(jsobol.direction_vectors(2)), dim=2,
        n_sample_blocks=nsb, bodies=jb.bodies, n_rounds=r, sampler="sobol",
        interpret=True, name=f"{jb.name}_r{r}"))
    got = template.fused_mc_plain(
        template.pack_scalars(key, 0, n, round_stride=n), b.fn_ids, b.packed,
        b.lo, b.hi, b.block_forms, dim=2, n_sample_blocks=nsb, n_rounds=r,
        round_base=multi._round_base_for(b, starts, n),
        block_tcols=b.block_tcols, sampler="sobol")
    return jb, b, want, got


def test_plan_spec_sobol_as_reference(sobol_launches):
    jb, b, _, _ = sobol_launches
    assert b.name == jb.name and b.name.startswith("mc_eval_fused_sobol_d2")
    for name in ("packed", "lo", "hi", "fn_ids"):
        np.testing.assert_array_equal(getattr(b, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    assert b.dirvecs.dtype == torch.int32
    np.testing.assert_array_equal(b.dirvecs.numpy().view(np.uint32),
                                  jsobol.direction_vectors(2))


def test_fused_plain_sobol_vs_repro_pallas(sobol_launches):
    jb, b, want, got = sobol_launches
    real = np.concatenate([np.arange(s.row_start, s.row_start + s.n_fn)
                           for s in b.slices])
    assert np.isfinite(got.numpy()[:, real]).all()
    np.testing.assert_allclose(got.numpy()[:, real], want[:, real], rtol=RTOL,
                               atol=ATOL)


def test_plain_sobol_fold_against_float64_sum():
    """The plain version's fold of 16384-sample chunk sums, held against a
    float64 sum of the same Sobol draws at 10^6 samples, where an f32 fold
    of 2048-sample block sums drifts past the chip's 1e-2-standard-error
    gate: Sobol block sums are nearly equal, so their rounding errors add
    up.  The functions differ only in their shifts; ids 8 and 9 drift most."""
    n = 10**6
    fam = integrand.abs_sum_family(16, 2, np.ones(16))
    (b,) = multi.plan_spec(integrand.MultiFunctionSpec.from_families([fam]),
                           sampler="sobol").buckets
    key = jrng.fold_key(0, 0)
    got = template.fused_mc_plain(
        template.pack_scalars(key, 0, n), b.fn_ids, b.packed, b.lo, b.hi,
        b.block_forms, dim=2, n_sample_blocks=n // template.S_BLK + 1,
        sampler="sobol")[0, :16, 0].double()
    s1 = torch.zeros(16, dtype=torch.float64)
    s2 = torch.zeros_like(s1)
    block_fold = torch.zeros(16)
    for c in range(0, n, template.CHUNK_SAMPLES):
        idx = torch.arange(c, min(n, c + template.CHUNK_SAMPLES))
        u = sobol.sobol_uniforms_for(*key, b.fn_ids[:16], idx, 2)
        v = fam.eval_batch(affine_from_unit(u, fam.domains[:, None, :, :]))
        s1 += v.double().sum(-1)
        s2 += v.double().square().sum(-1)
        for blk in v.split(template.S_BLK, dim=1):
            block_fold = block_fold + blk.sum(-1)
    mean = s1 / n
    se_sum = torch.sqrt(n * (s2 / n - mean.square()))    # stderr of s1
    drift = ((got - s1).abs() / se_sum).max().item()
    old_drift = ((block_fold.double() - s1).abs() / se_sum).max().item()
    assert drift <= 0.005, drift
    assert old_drift > 0.01, old_drift


def test_sobol_rejected_above_max_dim_and_unknown_sampler():
    ops_ = (template.pack_scalars((0, 0), 0, 16),
            torch.arange(16), torch.zeros(16, 11), torch.zeros(16, 9),
            torch.ones(16, 9), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="at most 8 dims"):
        template.fused_mc_plain(*ops_, dim=9, n_sample_blocks=1, sampler="sobol")
    with pytest.raises(ValueError, match="'mc' or 'sobol'"):
        template.fused_mc_plain(*ops_, dim=9, n_sample_blocks=1, sampler="qmc")


def test_historical_sobol_names():
    """ops.mc_eval_sobol_harmonic is the registry's Sobol impl of the
    harmonic form; sobol_kernel.mc_sobol_harmonic is one Sobol launch on
    unpacked (a, b, k) operands, equal to the fused launch."""
    assert ops.mc_eval_sobol_harmonic is registry.get("mc_eval_harmonic@sobol")
    assert ops.mc_eval_sobol_harmonic.sampler == "sobol"
    fam = integrand.harmonic_family(16, 3)
    key = jrng.fold_key(3, 3)
    scal = template.pack_scalars(key, 5, 3000)
    fid = torch.arange(16)
    p = fam.params
    got = sobol_kernel.mc_sobol_harmonic(
        scal, fid, p["a"][:, None], p["b"][:, None], p["k"],
        fam.domains[..., 0], fam.domains[..., 1], dim=3, n_sample_blocks=2)
    sums = direct_mc.family_sums(fam, 3000, key, sample_offset=5,
                                 use_kernel=True, sampler="sobol")
    torch.testing.assert_close(got[:, 0], sums.s1, rtol=0, atol=0)


def _jspec():
    return [jint.harmonic_family(10, 3), jint.gaussian_family(4, 2, lo=0.0, hi=INF),
            jgenz.oscillatory(5, 2)[0], jint.harmonic_family(2, 9)]


def test_evaluate_sobol_vs_reference():
    """Two Sobol trials through the port's fused path (plain version) and
    repro's chunked engine: the same points, so estimates within the
    bound; the dim-9 family degrades to MC in both."""
    n = 4096 + 77
    want = JZMC(_jspec(), n_samples=n, seed=4, sampler="sobol").evaluate(2)
    zmc = ZMCMultiFunctions([_port(f) for f in _jspec()], n_samples=n, seed=4,
                            use_kernel=True, sampler="sobol", device="cpu")
    template.reset_launch_count()
    got = zmc.evaluate(num_trials=2)
    # per trial: buckets d2 and d3, and the dim-9 family's own MC launch
    # (its Sobol request degrades to MC and use_kernel takes its form's impl)
    assert template.launch_count() == 2 * 3
    assert zmc._get_fusion_plan().unfused == (3,)
    np.testing.assert_allclose(got.means, want.means, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.stderrs, want.stderrs, rtol=RTOL, atol=ATOL)
    mc = ZMCMultiFunctions([_port(f) for f in _jspec()], n_samples=n, seed=4,
                           use_kernel=True, device="cpu").evaluate(2)
    # Sobol's spread across trials is far below MC's on the smooth Gaussians
    assert np.median(got.trial_std[10:14] / mc.trial_std[10:14]) < 0.5


def test_evaluate_resumable_sobol(tmp_path):
    """Checkpoint keys and tag as repro's; a crash after round 1 resumes
    to the uninterrupted sums."""
    fams = [_port(f) for f in _jspec()[:2]]
    kw = dict(n_samples=3000, seed=1, use_kernel=True, sampler="sobol",
              device="cpu")
    full = ZMCMultiFunctions(fams, **kw).evaluate_resumable(rounds=3)
    zmc = ZMCMultiFunctions(fams, **kw)
    assert zmc._ckpt_tag() == JZMC(_jspec()[:2], n_samples=3000, seed=1,
                                   sampler="sobol")._ckpt_tag()
    with pytest.raises(RuntimeError, match="injected"):
        zmc.evaluate_resumable(rounds=3, checkpoint_dir=str(tmp_path),
                               fail_after_round=1)
    with np.load(next(tmp_path.glob("*.npz"))) as data:
        assert int(data["round"]) == 2
        assert sorted(data.files) == sorted(
            ["round"] + [f"{k}_{i}" for k in ("s1", "s2", "n") for i in range(2)])
    resumed = ZMCMultiFunctions(fams, **kw).evaluate_resumable(
        rounds=3, checkpoint_dir=str(tmp_path))
    np.testing.assert_array_equal(resumed.means, full.means)


def test_service_sobol_requests_vs_reference():
    """Sobol requests through both engines: stream ids end in ':sobol',
    and the estimates agree within repro's MC bound on the service."""
    R = 4096

    def reqs(mod_int, req):
        return [req.make([mod_int.harmonic_family(6, 3)], n_samples=2 * R,
                         sampler="sobol"),
                req.make([mod_int.gaussian_family(4, 2, lo=-INF, hi=INF)],
                         n_samples=R, sampler="sobol")]

    def serve(eng, rs):
        tickets = [eng.submit(r) for r in rs]
        while eng.step():
            pass
        return [eng.poll(t) for t in tickets]

    want = serve(JEngine(round_samples=R, use_kernel=False), reqs(jint, JRequest))
    eng = IntegrationEngine(round_samples=R, device="cpu")
    got = serve(eng, reqs(integrand, IntegrationRequest))
    assert eng.batcher.fallback_rounds == 0
    for g, w in zip(got, want):
        assert g.stream_ids == w.stream_ids and g.stream_ids[0].endswith(":sobol")
        np.testing.assert_allclose(g.means, w.means, rtol=5e-5, atol=5e-3)
        np.testing.assert_allclose(g.stderrs, w.stderrs, rtol=5e-5, atol=5e-3)
