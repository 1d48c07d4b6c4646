"""The port on its own: the device rule, dispatch without fallback,
operand checks, the registry, the plain oracle, resume bit-identity, the
fault-tolerance helpers and the launcher, all on the CPU."""

import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import direct_mc, domains, genz, integrand, rng
from repro_torch.core.multifunctions import ZMCMultiFunctions
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import StepWatchdog, run_with_restarts
from repro_torch.kernels import build, registry, template
from repro_torch.kernels.mc_eval.ref import mc_harmonic_ref
from repro_torch.launch import integrate
from repro_torch.launch.mesh import make_mesh_for

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


def _spec():
    return integrand.MultiFunctionSpec.from_families([
        integrand.harmonic_family(6, 2),
        integrand.abs_sum_family(3, 3, np.ones(3), sign_last=-1.0),
        genz.corner_peak(4, 2)[0],
        genz.continuous(2, 2)[0],                 # no kernel: chunked path
    ])


def _bucket_operands(n_fn=16, dim=2, device="cpu"):
    fam = integrand.harmonic_family(n_fn, dim, device=device)
    form = registry.form("mc_eval_harmonic")
    return (template.pack_scalars((1, 2), 0, 4096),
            torch.arange(n_fn, dtype=torch.int64, device=device),
            form.pack_params(fam).contiguous(),
            fam.domains[..., 0].contiguous(), fam.domains[..., 1].contiguous(),
            torch.zeros(n_fn // 16, dtype=torch.int32))


# -- the device rule -------------------------------------------------------------

def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ZMCMultiFunctions(_spec())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        integrate.main(["--device", "cuda", "--n-functions", "2"])


def test_resolve_device_cpu_and_bad_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        resolve_device("meta")


@pytest.fixture
def mesh11(tmp_path):
    """A (1, 1) ("data", "model") mesh on a world-size-1 gloo group."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        yield make_mesh_for(device="cpu")
    finally:
        dist.destroy_process_group()


def test_not_ported_options_raise(mesh11):
    # the mesh is ported now: a (1, 1) mesh gives the single-device bits,
    # fused buckets and the chunked family alike
    for use_kernel in (True, False):
        want = ZMCMultiFunctions(_spec(), n_samples=3000, seed=2, device="cpu",
                                 use_kernel=use_kernel).evaluate(2)
        got = ZMCMultiFunctions(_spec(), n_samples=3000, seed=2, device="cpu",
                                use_kernel=use_kernel, mesh=mesh11).evaluate(2)
        np.testing.assert_array_equal(got.means, want.means)
        np.testing.assert_array_equal(got.stderrs, want.stderrs)
    # the Sobol sampler is ported now; only unknown samplers raise
    assert ZMCMultiFunctions(_spec(), sampler="sobol", device="cpu").sampler == "sobol"
    with pytest.raises(ValueError, match="unknown sampler"):
        ZMCMultiFunctions(_spec(), sampler="halton", device="cpu")
    fam = integrand.gaussian_family(2, 2, lo=-np.inf, hi=np.inf)
    # infinite boxes are ported now: the solver compactifies them
    zmc = ZMCMultiFunctions([fam], device="cpu")
    assert zmc.spec.families[0].compact
    assert domains.is_finite_box(zmc.spec.families[0].domains)
    with pytest.raises(ValueError, match="unknown sampler"):
        direct_mc.family_sums(fam, 10, (0, 0), sampler="halton")


# -- dispatch: plain on CPU tensors, kernel or an error elsewhere -----------------

def test_fused_mc_dispatch_counts_and_no_fallback():
    ops = _bucket_operands()
    template.reset_launch_count()
    template.reset_kernel_launch_count()
    out = template.fused_mc(*ops, dim=2, n_sample_blocks=2)
    assert tuple(out.shape) == (1, 16, 2) and out.dtype == torch.float32
    np.testing.assert_array_equal(
        out.numpy(), template.fused_mc_plain(*ops, dim=2, n_sample_blocks=2).numpy())
    assert template.launch_count() == 1
    assert template.kernel_launch_count() == 0       # no CUDA launch on the CPU
    meta = [t.to("meta") if i in (1, 2, 3, 4) else t for i, t in enumerate(ops)]
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        template.fused_mc(*meta, dim=2, n_sample_blocks=2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        template.fused_mc_cuda(*ops, dim=2, n_sample_blocks=2)
    with pytest.raises(ValueError, match="CUDA device"):
        template.random_bits_cuda(1, 2, ops[1], ops[1])


@pytest.mark.parametrize("bad,match", [
    (lambda o: (o[0], o[1][:15], *o[2:]), "multiple of 16"),
    (lambda o: (o[0], o[1], o[2][:8], *o[3:]), r"packed must be \(16, n_cols\)"),
    (lambda o: (*o[:3], o[3][:, :1], *o[4:]), r"lo must be \(16, 2\)"),
    (lambda o: (*o[:2], o[2].double(), *o[3:]), "float32"),
    (lambda o: (o[0][:3], *o[1:]), r"scalars must be u32\[4\]"),
    (lambda o: (*o[:5], torch.zeros(2, dtype=torch.int32)), "block_forms"),
    (lambda o: (o[0], o[1].float(), *o[2:]), "u32 values"),
])
def test_operand_checks(bad, match):
    ops = bad(_bucket_operands())
    with pytest.raises((ValueError, TypeError), match=match):
        template.fused_mc_plain(*ops, dim=2, n_sample_blocks=1)


def test_nvcc_missing_raises_clearly(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("the CUDA toolkit is installed at its default path")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


# -- registry ---------------------------------------------------------------------

def test_registry_lookup_and_errors():
    assert registry.lookup("mc_eval_gaussian", dim=3) is registry.get("mc_eval_gaussian")
    assert registry.lookup("mc_eval_gaussian", dim=3, sampler="sobol") is \
        registry.get("mc_eval_gaussian@sobol")
    assert registry.lookup("mc_eval_gaussian", dim=9, sampler="sobol") is None
    assert registry.lookup("mc_eval_gaussian", dim=257) is None
    assert registry.lookup("nope", dim=2) is None
    with pytest.raises(ValueError, match="sobol dim<=8"):
        registry.lookup("mc_eval_gaussian", dim=9, sampler="sobol", required=True)
    with pytest.raises(KeyError):
        registry.get("nope")
    with pytest.raises(KeyError, match="form_id 9"):
        registry.by_id(9)
    f = registry.form("mc_eval_abs_sum")
    with pytest.raises(ValueError, match="already registered"):
        registry.register_form(f)
    clash = registry.KernelForm(name="clash", form_id=f.form_id, body=f.body,
                                pack_params=f.pack_params, n_cols=f.n_cols)
    with pytest.raises(ValueError, match="free index"):
        registry.register_form(clash)
    assert registry.form("mc_eval_abs_sum@mc") is f


# -- the plain oracle -------------------------------------------------------------

@pytest.mark.parametrize("n_samples,offset", [(100, 0), (2 * 2048 + 13, 2**32 - 999)])
def test_fused_plain_vs_harmonic_oracle(n_samples, offset):
    fam = integrand.harmonic_family(5, 3)
    key = rng.fold_key(31, 0)
    nsb = -(-n_samples // template.S_BLK)
    ref = mc_harmonic_ref(template.pack_scalars(key, offset, n_samples),
                          torch.arange(5) + 40, fam.params["a"][:, None],
                          fam.params["b"][:, None], fam.params["k"],
                          fam.domains[..., 0], fam.domains[..., 1], dim=3,
                          n_sample_blocks=nsb)
    got = registry.get("mc_eval_harmonic")(fam, n_samples, key, fn_offset=40,
                                           sample_offset=offset)
    np.testing.assert_allclose(got.s1.numpy(), ref[:, 0].numpy(), rtol=5e-5, atol=5e-3)
    np.testing.assert_allclose(got.s2.numpy(), ref[:, 1].numpy(), rtol=5e-5, atol=5e-3)
    eng = direct_mc.family_sums(fam, n_samples, key, fn_offset=40,
                                sample_offset=offset, chunk=1024)
    np.testing.assert_allclose(eng.s1.numpy(), ref[:, 0].numpy(), rtol=5e-5, atol=5e-3)


def test_finalize_and_merge():
    fam = integrand.gaussian_family(3, 2)
    a = direct_mc.family_sums(fam, 3000, (5, 6))
    b = direct_mc.family_sums(fam, 3000, (5, 6), sample_offset=3000)
    both = direct_mc.family_sums(fam, 6000, (5, 6), chunk=3000)
    m = direct_mc.merge_sums(a, b)
    np.testing.assert_allclose(m.s1.numpy(), both.s1.numpy(), rtol=1e-6)
    assert float(m.n) == 6000.0
    res = direct_mc.finalize(fam, m)
    sigma = np.linspace(0.5, 2.0, 3)          # the box [-4, 4]^2 truncates
    exact = (sigma * np.sqrt(2 * np.pi)
             * np.array([math.erf(4 / (s * math.sqrt(2))) for s in sigma])) ** 2
    assert np.all(np.abs(res.mean.numpy() - exact) < 6 * res.stderr.numpy() + 0.05)


# -- resume ---------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False])
def test_resume_is_bit_identical(tmp_path, use_kernel):
    kw = dict(n_samples=6000, seed=3, use_kernel=use_kernel, device="cpu")
    full = ZMCMultiFunctions(_spec(), **kw).evaluate_resumable(rounds=3)
    z = ZMCMultiFunctions(_spec(), **kw)
    with pytest.raises(RuntimeError, match="injected failure after round 1"):
        z.evaluate_resumable(rounds=3, checkpoint_dir=str(tmp_path),
                             fail_after_round=1)
    path = tmp_path / f"zmc_{z._ckpt_tag()}_t0.npz"
    with np.load(path) as data:
        assert int(data["round"]) == 2
        assert sorted(data.files) == sorted(
            ["round"] + [f"{k}_{i}" for k in ("s1", "s2", "n") for i in range(4)])
    resumed = ZMCMultiFunctions(_spec(), **kw).evaluate_resumable(
        rounds=3, checkpoint_dir=str(tmp_path))
    np.testing.assert_array_equal(resumed.means, full.means)
    np.testing.assert_array_equal(resumed.stderrs, full.stderrs)
    assert resumed.names == full.names


def test_kernel_and_chunked_paths_agree():
    kw = dict(n_samples=5000, seed=1, device="cpu")
    template.reset_launch_count()
    rk = ZMCMultiFunctions(_spec(), use_kernel=True, **kw).evaluate(num_trials=2)
    assert template.launch_count() == 2 * 2            # dims 2 and 3, 2 trials
    rc = ZMCMultiFunctions(_spec(), **kw).evaluate(num_trials=2)
    np.testing.assert_allclose(rk.means, rc.means, rtol=5e-5, atol=5e-3)
    np.testing.assert_allclose(rk.trial_std, rc.trial_std, rtol=1e-3, atol=5e-3)


# -- fault tolerance and the launcher ----------------------------------------------

def test_watchdog_and_restarts():
    wd = StepWatchdog(threshold=3.0, warmup=3)
    wd.durations = [0.01] * 5
    import time
    with wd:
        time.sleep(0.1)
    assert wd.straggler_count == 1 and wd.events[0].step == 0
    calls = []

    def body(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise RuntimeError("boom")
        return "done"

    seen = []
    assert run_with_restarts(body, max_restarts=3,
                             on_restart=lambda a, e: seen.append(a)) == "done"
    assert calls == [0, 1, 2] and seen == [0, 1]
    with pytest.raises(RuntimeError, match="boom"):
        run_with_restarts(lambda a: (_ for _ in ()).throw(RuntimeError("boom")),
                          max_restarts=1)


def test_launcher_on_cpu(tmp_path, capsys):
    within = integrate.main(["--device", "cpu", "--n-functions", "4", "--dim", "2",
                             "--samples", "4096", "--trials", "2", "--rounds", "2",
                             "--use-kernel", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "4 integrands" in out and "on cpu" in out
    assert 0 <= within <= 4
    assert len(list(tmp_path.glob("zmc_*_t*.npz"))) == 2
