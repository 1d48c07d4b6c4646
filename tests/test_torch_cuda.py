"""The CUDA kernels on the card: the fused kernel against its plain
version, bit-identical repeats and row independence, the device
Threefry bit for bit, and the solver on the card against the CPU.

Marked ``cuda``; each test skips (with the reason) where there is no GPU.
On a machine with one:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import direct_mc, genz, integrand, rng
from repro_torch.core.multifunctions import ZMCMultiFunctions
from repro_torch.kernels import template
from repro_torch.kernels.mc_eval import multi

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (nvcc builds the kernel on first use)")
    return torch.device("cuda", 0)


def _spec(device):
    return integrand.MultiFunctionSpec.from_families([
        integrand.harmonic_family(40, 3),
        integrand.abs_sum_family(9, 3, np.linspace(0.5, 2, 9), sign_last=-1.0),
        integrand.gaussian_family(7, 3),
        genz.oscillatory(21, 3)[0],
        genz.corner_peak(6, 3)[0],
    ]).to(device)


def _launch(fn, b, n, key, offset=0):
    return fn(template.pack_scalars(key, offset, n), b.fn_ids, b.packed, b.lo,
              b.hi, b.block_forms, dim=b.dim,
              n_sample_blocks=math.ceil(n / template.S_BLK))[0]


@pytest.mark.parametrize("n,offset", [(1, 0), (2048 * 9 + 5, 2**32 - 20000),
                                      (65536, 12345)])
def test_kernel_vs_plain_mixed_bucket(cuda, n, offset):
    (b,) = multi.plan_spec(_spec(cuda)).buckets
    key = rng.fold_key(9, 4)
    template.reset_kernel_launch_count()
    got = _launch(template.fused_mc_cuda, b, n, key, offset)
    assert template.kernel_launch_count() == 1
    want = _launch(template.fused_mc_plain, b, n, key, offset)
    real = torch.cat([torch.arange(s.row_start, s.row_start + s.n_fn)
                      for s in b.slices]).to(cuda)
    torch.testing.assert_close(got[real], want[real], rtol=1e-4, atol=1e-2)


def test_repeats_and_rows_are_bit_identical(cuda):
    (b,) = multi.plan_spec(_spec(cuda)).buckets
    key = rng.fold_key(1, 1)
    a = _launch(template.fused_mc_cuda, b, 50_000, key)
    again = _launch(template.fused_mc_cuda, b, 50_000, key)
    # bit patterns: the gaussian's zero padding rows sum NaN (0/0), as in repro
    assert torch.equal(a.view(torch.int32), again.view(torch.int32))
    s = b.slices[0]                         # the harmonic family, alone
    rows = slice(s.row_start, s.row_start + math.ceil(s.n_fn / 16) * 16)
    one = template.fused_mc_cuda(
        template.pack_scalars(key, 0, 50_000), b.fn_ids[rows],
        b.packed[rows].contiguous(), b.lo[rows].contiguous(),
        b.hi[rows].contiguous(), b.block_forms[:rows.stop // 16], dim=b.dim,
        n_sample_blocks=math.ceil(50_000 / template.S_BLK))[0]
    assert torch.equal(one[:s.n_fn], a[:s.n_fn])


def test_device_threefry_bit_exact(cuda):
    i = torch.arange(1 << 16, dtype=torch.int64, device=cuda)
    c0 = (2**32 - 1000 + i) & rng.MASK32
    c1 = ((i * 40503) % (1 << 24)) * rng.DIM_STRIDE + i % rng.DIM_STRIDE
    got = template.random_bits_cuda(7, 8, c0, c1)
    assert torch.equal(got, rng.random_bits(7, 8, c0, c1))


def test_solver_on_card_vs_cpu(cuda):
    kw = dict(n_samples=30_000, seed=2, use_kernel=True)
    gpu = ZMCMultiFunctions(_spec("cpu"), device="cuda", **kw).evaluate(2)
    cpu = ZMCMultiFunctions(_spec("cpu"), device="cpu", **kw).evaluate(2)
    np.testing.assert_allclose(gpu.means, cpu.means, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(gpu.stderrs, cpu.stderrs, rtol=1e-3, atol=1e-3)


# -- multi-round launches and the compactified stage -------------------------

def _round_case(device, n_rounds=3):
    (b,) = multi.plan_spec(_spec(device)).buckets
    n_blocks = b.fn_ids.shape[0] // 16
    # window starts at other depths per block, one just below 2^32 so the
    # rounds cross the u32 wrap
    base = torch.tensor([(i * 7 * 4096) for i in range(n_blocks)],
                        dtype=torch.int64)
    base[-1] = 2**32 - 5000
    return b, base


def test_rounds_bit_identical_to_single_rounds(cuda):
    b, base = _round_case(cuda)
    key, n, stride, n_rounds = rng.fold_key(5, 2), 20_000, 20_000, 3
    nsb = math.ceil(n / template.S_BLK)
    template.reset_kernel_launch_count()
    multi_round = template.fused_mc_cuda(
        template.pack_scalars(key, 11, n, round_stride=stride), b.fn_ids,
        b.packed, b.lo, b.hi, b.block_forms, dim=b.dim, n_sample_blocks=nsb,
        n_rounds=n_rounds, round_base=base, block_tcols=b.block_tcols)
    assert template.kernel_launch_count() == 1
    assert multi_round.shape == (n_rounds, b.fn_ids.shape[0], 2)
    for r in range(n_rounds):
        single = template.fused_mc_cuda(
            template.pack_scalars(key, 11 + r * stride, n), b.fn_ids,
            b.packed, b.lo, b.hi, b.block_forms, dim=b.dim,
            n_sample_blocks=nsb, round_base=base, block_tcols=b.block_tcols)[0]
        assert torch.equal(multi_round[r].view(torch.int32),
                           single.view(torch.int32))
    plain = template.fused_mc_plain(
        template.pack_scalars(key, 11, n, round_stride=stride), b.fn_ids,
        b.packed, b.lo, b.hi, b.block_forms, dim=b.dim, n_sample_blocks=nsb,
        n_rounds=n_rounds, round_base=base, block_tcols=b.block_tcols)
    real = torch.cat([torch.arange(s.row_start, s.row_start + s.n_fn)
                      for s in b.slices]).to(cuda)
    torch.testing.assert_close(multi_round[:, real], plain[:, real],
                               rtol=1e-4, atol=1e-2)


def _compact_spec(device):
    inf = float("inf")
    return integrand.MultiFunctionSpec.from_families([
        integrand.gaussian_family(9, 3, lo=-inf, hi=inf),
        integrand.gaussian_family(7, 3, lo=0.0, hi=inf),
        integrand.gaussian_family(5, 3, lo=-inf, hi=0.5),
        integrand.harmonic_family(20, 3),
        genz.oscillatory(6, 3)[0],
    ]).to(device)


def test_compactified_kernel_vs_plain(cuda):
    spec = ZMCMultiFunctions(_compact_spec(cuda), device="cuda").spec
    (b,) = multi.plan_spec(spec).buckets
    assert sorted(set(b.block_tcols.tolist())) == [-1, 1]
    key, n = rng.fold_key(6, 3), 65536
    nsb = n // template.S_BLK
    args = (template.pack_scalars(key, 0, n), b.fn_ids, b.packed, b.lo, b.hi,
            b.block_forms)
    got = template.fused_mc_cuda(*args, dim=b.dim, n_sample_blocks=nsb,
                                 block_tcols=b.block_tcols)[0]
    want = template.fused_mc_plain(*args, dim=b.dim, n_sample_blocks=nsb,
                                   block_tcols=b.block_tcols)[0]
    real = torch.cat([torch.arange(s.row_start, s.row_start + s.n_fn)
                      for s in b.slices]).to(cuda)
    assert torch.isfinite(got[real]).all()
    torch.testing.assert_close(got[real], want[real], rtol=1e-4, atol=1e-2)


def test_compactified_sobol_kernel_vs_plain(cuda):
    """A Sobol launch whose blocks are all compactified (fused_mc_pass1<1,
    true, true>, its transform loop only) against the plain version within
    repro's Sobol bound."""
    inf = float("inf")
    spec = ZMCMultiFunctions(integrand.MultiFunctionSpec.from_families([
        integrand.gaussian_family(16, 3, lo=-inf, hi=inf),
        integrand.gaussian_family(16, 3, lo=0.0, hi=inf),
        integrand.gaussian_family(16, 3, lo=-inf, hi=0.5),
    ]).to(cuda), device="cuda").spec
    (b,) = multi.plan_spec(spec, sampler="sobol").buckets
    assert (b.block_tcols >= 0).all()
    key, n = rng.fold_key(6, 5), 65536
    args = (template.pack_scalars(key, 2**32 - 3000, n), b.fn_ids, b.packed, b.lo, b.hi,
            b.block_forms)
    kw = dict(dim=b.dim, n_sample_blocks=n // template.S_BLK, block_tcols=b.block_tcols,
              sampler="sobol")
    template.reset_kernel_launch_count()
    got = template.fused_mc_cuda(*args, dirvecs=b.dirvecs, **kw)[0]
    counts = template.kernel_launch_counts()
    assert counts["fused_mc_sobol"] == counts["fused_mc_compactified"] == 1
    want = template.fused_mc_plain(*args, **kw)[0]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("form", range(5))
def test_mc_loop_per_form_vs_plain(cuda, form):
    """Each form alone in an MC launch without stages
    (fused_mc_pass1<0, false, false>, the main path's loop), its window
    crossing 2^32 and its last chunk cut, against the plain version."""
    fam = _spec(cuda).families[form]
    (b,) = multi.plan_spec(integrand.MultiFunctionSpec.from_families([fam])).buckets
    assert set(b.block_forms.tolist()) == {form}
    key, n, offset = rng.fold_key(9, 5), 2048 * 9 + 5, 2**32 - 20000
    template.reset_kernel_launch_count()
    got = _launch(template.fused_mc_cuda, b, n, key, offset)
    assert template.kernel_launch_counts()["fused_mc"] == 1
    want = _launch(template.fused_mc_plain, b, n, key, offset)
    real = torch.arange(fam.n_fn, device=cuda)
    torch.testing.assert_close(got[real], want[real], rtol=1e-4, atol=1e-2)


def test_pipelined_service_on_card(cuda):
    from repro_torch.launch.serve_integrals import demo_workload
    from repro_torch.service import IntegrationEngine

    def serve(device, thread):
        engine = IntegrationEngine(round_samples=4096, device=device,
                                   max_rounds_per_wave=4)
        try:
            reqs = demo_workload(14, n_fn=4, n_samples=8192)
            if thread:
                engine.start()
                tickets = [engine.submit(r) for r in reqs]
                out = [engine.result(t, timeout=300.0) for t in tickets]
            else:
                tickets = [engine.submit(r) for r in reqs]
                while engine.step():
                    pass
                out = [engine.poll(t) for t in tickets]
        finally:
            engine.close(timeout=60.0)
        return engine, out

    engine, gpu = serve("cuda", thread=True)
    assert engine.batcher.fallback_rounds == 0
    _, cpu = serve("cpu", thread=False)
    for g, c in zip(gpu, cpu):
        np.testing.assert_allclose(g.means, c.means, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(g.stderrs, c.stderrs, rtol=1e-3, atol=1e-3)


def test_chunked_service_on_card(cuda):
    """The chunked path on the card (``use_kernel=False``): every wave's
    sums are copied to the host behind the wave's event, so the served
    means equal the CPU run's."""
    from repro_torch.launch.serve_integrals import demo_workload
    from repro_torch.service import IntegrationEngine

    def serve(device, thread):
        engine = IntegrationEngine(round_samples=4096, device=device,
                                   use_kernel=False, max_rounds_per_wave=2)
        try:
            reqs = demo_workload(10, n_fn=4, n_samples=8192)
            if thread:
                engine.start()
                tickets = [engine.submit(r) for r in reqs]
                out = [engine.result(t, timeout=300.0) for t in tickets]
            else:
                tickets = [engine.submit(r) for r in reqs]
                while engine.step():
                    pass
                out = [engine.poll(t) for t in tickets]
        finally:
            engine.close(timeout=60.0)
        return engine, out

    engine, gpu = serve("cuda", thread=True)
    assert engine.batcher.fallback_rounds > 0
    _, cpu = serve("cpu", thread=False)
    for g, c in zip(gpu, cpu):
        assert np.isfinite(g.means).all() and (g.stderrs > 0).all()
        np.testing.assert_allclose(g.means, c.means, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(g.stderrs, c.stderrs, rtol=1e-3, atol=1e-3)


def test_plan_metadata_on_card_bit_identical(cuda):
    """A launch with the plan's on-card block metadata and no round bases
    (the kernel starts every window at sample_offset) equals one that
    copies both from the host."""
    (b,) = multi.plan_spec(ZMCMultiFunctions(_compact_spec(cuda),
                                             device="cuda").spec).buckets
    assert b.block_meta.device == b.packed.device
    key, n = rng.fold_key(8, 1), 40_000
    args = (template.pack_scalars(key, 77, n), b.fn_ids, b.packed, b.lo, b.hi,
            b.block_forms)
    kw = dict(dim=b.dim, n_sample_blocks=math.ceil(n / template.S_BLK),
              block_tcols=b.block_tcols)
    on_card = template.fused_mc_cuda(*args, block_meta=b.block_meta, **kw)
    copied = template.fused_mc_cuda(
        *args, round_base=torch.zeros(b.block_forms.shape[0], dtype=torch.int64),
        **kw)
    assert torch.equal(on_card.view(torch.int32), copied.view(torch.int32))


# -- the Sobol and swept stages -----------------------------------------------

def test_device_sobol_points_and_shifts_bit_exact(cuda):
    """The compiled header's sobol_point and sobol_shift against the
    port's core/sobol.py (itself bit-exact with repro's), across the c0
    wrap, at every Sobol dim."""
    from repro_torch.core import sobol
    i = torch.arange(1 << 16, dtype=torch.int64, device=cuda)
    idx = (2**32 - 20_000 + i * 3) & rng.MASK32
    fid = (i * 40503) % (1 << 24)
    for dim in (1, 4, 8):
        pts, shs = template.sobol_cuda(5, 6, idx, fid, dim)
        assert torch.equal(pts, sobol.sobol_bits(idx, dim))
        d = torch.arange(dim, device=cuda)
        want = rng.random_bits(5, 6, torch.full((1,), sobol.SHIFT_C0, device=cuda),
                               rng.counter_c1(fid[:, None], d[None, :]))
        assert torch.equal(shs, want)


def test_device_walked_sobol_points_bit_exact(cuda):
    """The points pass 1 walks (each of 256 threads from its first index
    along its stride-256 run, sobol_walk) against core.sobol at every
    Sobol dim, over runs that cross 2^32."""
    from repro_torch.core import sobol
    start = 2**32 - 256 * 40 - 123
    n = 256 * 90 + 17
    idx = (start + torch.arange(n, dtype=torch.int64, device=cuda)) & rng.MASK32
    for dim in range(1, sobol.MAX_DIM + 1):
        pts = template.sobol_walk_cuda(start, n, dim, cuda)
        assert torch.equal(pts, sobol.sobol_bits(idx, dim))


def _sobol_bucket(device):
    spec = ZMCMultiFunctions(_compact_spec(device), device=device).spec
    (b,) = multi.plan_spec(spec, sampler="sobol").buckets
    return b


@pytest.mark.parametrize("n,offset", [(2048 * 9 + 5, 2**32 - 20000), (65536, 0)])
def test_sobol_kernel_vs_plain(cuda, n, offset):
    """Sobol draws on a mixed bucket with compactified rows: the kernel
    against its plain version within repro's Sobol bound."""
    b = _sobol_bucket(cuda)
    assert b.dirvecs is not None and sorted(set(b.block_tcols.tolist())) == [-1, 1]
    key = rng.fold_key(3, 8)
    args = (template.pack_scalars(key, offset, n), b.fn_ids, b.packed, b.lo,
            b.hi, b.block_forms)
    kw = dict(dim=b.dim, n_sample_blocks=math.ceil(n / template.S_BLK),
              block_tcols=b.block_tcols, sampler="sobol")
    template.reset_kernel_launch_count()
    got = template.fused_mc_cuda(*args, dirvecs=b.dirvecs, **kw)[0]
    assert template.kernel_launch_counts()["fused_mc_sobol"] == 1
    want = template.fused_mc_plain(*args, **kw)[0]
    real = torch.cat([torch.arange(s.row_start, s.row_start + s.n_fn)
                      for s in b.slices]).to(cuda)
    assert torch.isfinite(got[real]).all()
    torch.testing.assert_close(got[real], want[real], rtol=1e-4, atol=1e-2)


def test_sobol_rounds_bit_identical_to_single_rounds(cuda):
    b = _sobol_bucket(cuda)
    n_blocks = b.fn_ids.shape[0] // 16
    base = torch.tensor([(i * 5 * 4096) for i in range(n_blocks)],
                        dtype=torch.int64)
    base[-1] = 2**32 - 5000
    key, n, n_rounds = rng.fold_key(5, 2), 20_000, 3
    kw = dict(dim=b.dim, n_sample_blocks=math.ceil(n / template.S_BLK),
              round_base=base, block_tcols=b.block_tcols, sampler="sobol")
    ops = (b.fn_ids, b.packed, b.lo, b.hi, b.block_forms)
    multi_round = template.fused_mc_cuda(
        template.pack_scalars(key, 11, n, round_stride=n), *ops,
        n_rounds=n_rounds, **kw)
    for r in range(n_rounds):
        single = template.fused_mc_cuda(
            template.pack_scalars(key, 11 + r * n, n), *ops, **kw)[0]
        assert torch.equal(multi_round[r].view(torch.int32),
                           single.view(torch.int32))


@pytest.mark.parametrize("sampler", ["mc", "sobol"])
@pytest.mark.parametrize("lo", [0.0, -float("inf")])
def test_swept_bit_identical_to_per_point(cuda, sampler, lo):
    """A swept family's rows equal, bit for bit, the same points launched
    as their own families with the same fn ids (repro's
    test_swept_bit_identical_to_per_point, on the card), finite and
    compactified, for both samplers; one launch for the whole sweep."""
    a = np.linspace(0.5, 2.0, 20).astype(np.float32)
    k = np.stack([np.full(3, 3.0 + j, np.float32) for j in range(20)])
    tmpl = integrand.harmonic_family(1, 3, lo=lo, hi=1.0)
    sw = tmpl.swept_over({"a": a, "k": k}).compactified().to(cuda)
    key, n = rng.fold_key(11, 0), 30_000
    template.reset_kernel_launch_count()
    fused = direct_mc.family_sums(sw, n, key, use_kernel=True, sampler=sampler)
    counts = template.kernel_launch_counts()
    assert counts["fused_mc"] == 1 and counts["fused_mc_swept"] == 1
    for j in range(len(a)):
        pt = integrand.harmonic_family(1, 3, a=a[j:j + 1], k=k[j:j + 1], lo=lo,
                                       hi=1.0).compactified().to(cuda)
        one = direct_mc.family_sums(pt, n, key, fn_offset=j, use_kernel=True,
                                    sampler=sampler)
        assert torch.equal(fused.s1[j:j + 1].view(torch.int32),
                           one.s1.view(torch.int32))
        assert torch.equal(fused.s2[j:j + 1].view(torch.int32),
                           one.s2.view(torch.int32))


def test_swept_kernel_vs_plain(cuda):
    a = np.linspace(0.5, 2.0, 40).astype(np.float32)
    sw = integrand.gaussian_family(1, 2).swept_over(
        {"sigma": np.linspace(0.6, 1.8, 40)})
    spec = integrand.MultiFunctionSpec.from_families([
        integrand.harmonic_family(1, 2).swept_over({"a": a}), sw,
        integrand.harmonic_family(9, 2)]).to(cuda)
    (b,) = multi.plan_spec(spec).buckets
    assert b.block_sweep is not None
    key, n = rng.fold_key(2, 2), 65536
    args = (template.pack_scalars(key, 0, n), b.fn_ids, b.packed, b.lo, b.hi,
            b.block_forms)
    kw = dict(dim=b.dim, n_sample_blocks=n // template.S_BLK,
              block_sweep=b.block_sweep)
    got = template.fused_mc_cuda(*args, block_meta=b.block_meta, **kw)[0]
    want = template.fused_mc_plain(*args, **kw)[0]
    real = torch.cat([torch.arange(s.row_start, s.row_start + s.n_fn)
                      for s in b.slices]).to(cuda)
    torch.testing.assert_close(got[real], want[real], rtol=1e-4, atol=1e-2)


def _adapted_spec(device):
    """One dim-3 bucket: an adapted Genz corner peak, compactified then
    adapted Gaussians over R^3, and a plain harmonic family; each grid
    fit from one pilot on the CPU."""
    from repro_torch.core import adaptive
    key = rng.fold_key(4, 4)

    def fit(fam, n_bins):
        edges = adaptive.initial_edges(fam.domains, n_bins)
        return fam.adapted(adaptive.refine_edges(
            edges, adaptive.pilot_weights(fam, edges, key, 2048)))

    inf = float("inf")
    return integrand.MultiFunctionSpec.from_families([
        fit(genz.corner_peak(20, 3, difficulty=4.0)[0], 16),
        fit(integrand.gaussian_family(9, 3, sigma=np.linspace(0.2, 0.4, 9),
                                      lo=-inf, hi=inf).compactified(), 8),
        integrand.harmonic_family(12, 3),
    ]).to(device)


@pytest.mark.parametrize("sampler", ["mc", "sobol"])
@pytest.mark.parametrize("n,offset", [(2048 * 9 + 5, 2**32 - 20000), (65536, 0)])
def test_adapted_kernel_vs_plain(cuda, sampler, n, offset):
    """Adapted, adapted-and-compactified and plain blocks in one launch:
    the kernel against its plain version within repro's Sobol bound."""
    (b,) = multi.plan_spec(_adapted_spec(cuda), sampler=sampler).buckets
    assert b.block_adapt[0].tolist().count(-1) == 1
    assert sorted(set(b.block_adapt[1].tolist())) == [0, 8, 16]
    key = rng.fold_key(3, 8)
    args = (template.pack_scalars(key, offset, n), b.fn_ids, b.packed, b.lo,
            b.hi, b.block_forms)
    kw = dict(dim=b.dim, n_sample_blocks=math.ceil(n / template.S_BLK),
              block_tcols=b.block_tcols, block_adapt=b.block_adapt,
              sampler=sampler)
    template.reset_kernel_launch_count()
    got = template.fused_mc_cuda(*args, block_meta=b.block_meta,
                                 dirvecs=b.dirvecs, **kw)[0]
    assert template.kernel_launch_counts()["fused_mc_adapted"] == 1
    want = template.fused_mc_plain(*args, **kw)[0]
    real = torch.cat([torch.arange(s.row_start, s.row_start + s.n_fn)
                      for s in b.slices]).to(cuda)
    assert torch.isfinite(got[real]).all()
    torch.testing.assert_close(got[real], want[real], rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("sampler", ["mc", "sobol"])
def test_adapted_rounds_bit_identical_to_single_rounds(cuda, sampler):
    (b,) = multi.plan_spec(_adapted_spec(cuda), sampler=sampler).buckets
    n_blocks = b.fn_ids.shape[0] // 16
    base = torch.tensor([(i * 5 * 4096) for i in range(n_blocks)],
                        dtype=torch.int64)
    base[-1] = 2**32 - 5000
    key, n, n_rounds = rng.fold_key(5, 2), 20_000, 3
    kw = dict(dim=b.dim, n_sample_blocks=math.ceil(n / template.S_BLK),
              round_base=base, block_tcols=b.block_tcols,
              block_adapt=b.block_adapt, sampler=sampler)
    ops = (b.fn_ids, b.packed, b.lo, b.hi, b.block_forms)
    multi_round = template.fused_mc_cuda(
        template.pack_scalars(key, 11, n, round_stride=n), *ops,
        n_rounds=n_rounds, **kw)
    again = template.fused_mc_cuda(
        template.pack_scalars(key, 11, n, round_stride=n), *ops,
        n_rounds=n_rounds, **kw)
    assert torch.equal(multi_round.view(torch.int32), again.view(torch.int32))
    for r in range(n_rounds):
        single = template.fused_mc_cuda(
            template.pack_scalars(key, 11 + r * n, n), *ops, **kw)[0]
        assert torch.equal(multi_round[r].view(torch.int32),
                           single.view(torch.int32))


def test_adapted_evaluate_on_card_vs_cpu(cuda):
    """ZMCMultiFunctions on adapted families: the card's kernel and the
    CPU's plain version agree within repro's MC bound on the estimates."""
    spec = _adapted_spec("cpu")
    got = ZMCMultiFunctions(spec.to(cuda), n_samples=50_000, seed=2,
                            use_kernel=True, device="cuda").evaluate(2)
    want = ZMCMultiFunctions(spec, n_samples=50_000, seed=2,
                             use_kernel=True, device="cpu").evaluate(2)
    np.testing.assert_allclose(got.means, want.means, rtol=5e-5, atol=5e-3)
    np.testing.assert_allclose(got.stderrs, want.stderrs, rtol=5e-5, atol=5e-3)


@pytest.mark.parametrize("rows,cols", [(13, 512), (6561, 2048), (40, 4096)])
def test_stratum_moments_kernel_vs_plain(cuda, rows, cols):
    """The stratum-moments kernel against its plain version and the
    two-pass oracle (repro's bounds: count exact, mean atol=1e-5 at the
    data's scale, M2 rtol=1e-4), and repeated launches bit for bit."""
    from repro_torch.kernels.moments import ops, ref
    g = torch.Generator().manual_seed(rows + cols)
    x = (torch.randn(rows, cols, generator=g)
         * torch.arange(1, rows + 1)[:, None] / rows
         + torch.arange(rows)[:, None] / rows).to(cuda)
    ops.reset_kernel_launch_count()
    got = ops.stratum_moments(x)
    again = ops.stratum_moments(x)
    assert ops.kernel_launch_count() == 2
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    plain = ops.moments_plain(torch.nn.functional.pad(
        x, [0, 0, 0, -rows % ops.R_BLK]))[:rows]
    want = ref.moments_ref(x)
    for w in (plain, want):
        torch.testing.assert_close(got.count, w[:, 0], rtol=0, atol=0)
        torch.testing.assert_close(got.mean, w[:, 1], rtol=0, atol=1e-5)
        torch.testing.assert_close(got.m2, w[:, 2], rtol=1e-4, atol=0)


def test_eval_strata_kernel_on_card(cuda):
    from repro_torch.core import stratified
    table = stratified.initial_grid(np.tile([[0.0, 1.0]], (3, 1)), 4, 64,
                                    device=cuda)
    fn = lambda x: torch.exp(-4.0 * torch.sum(torch.square(x - 0.7), -1))
    slots = torch.arange(64, device=cuda)
    key = rng.fold_key(8, 1)
    mean_k, var_k = stratified.eval_strata(fn, table.boxes, slots, 1, 1024,
                                           key, use_kernel=True)
    mean_p, var_p = stratified.eval_strata(fn, table.boxes, slots, 1, 1024, key)
    torch.testing.assert_close(mean_k, mean_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(var_k, var_p, rtol=1e-3, atol=1e-6)


def test_world_size_one_mesh_on_card(cuda, tmp_path):
    """A (1, 1) mesh of a world-size-1 NCCL group: the single-device bits,
    the fused buckets through the CUDA kernel, the chunked family through
    the sharded chunked path, the result on the card."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_for
    spec = integrand.MultiFunctionSpec.from_families(
        list(_spec(cuda).families) + [genz.continuous(5, 3)[0].to(cuda)])
    want = ZMCMultiFunctions(spec, n_samples=65536, seed=3, use_kernel=True,
                             device="cuda").evaluate(2)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        template.reset_kernel_launch_count()
        got = ZMCMultiFunctions(spec, n_samples=65536, seed=3, use_kernel=True,
                                mesh=make_mesh_for(device="cuda")).evaluate(2)
        assert template.kernel_launch_count() == 2
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got.means.view(np.uint32), want.means.view(np.uint32))
    np.testing.assert_array_equal(got.stderrs.view(np.uint32),
                                  want.stderrs.view(np.uint32))
