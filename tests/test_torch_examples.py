"""The port's example scripts (``examples/*_torch.py``) against the
reference scripts at the same seeds, at reduced sizes, on the CPU.

Each test builds the reference script's spec with ``repro`` (the same jnp
families) and calls the port script's ``main(device="cpu", ...)``: per
trial, the raw sums within repro's MC bound (rtol=5e-5, atol=5e-3) and
every estimate and standard error within 1e-2 of a standard error (so
``trial_mean`` too), and the printed 2-sigma coverage equal to the
reference's.  repro runs its chunked engine, whose sums repro's own tests
hold to its kernel's.  ``examples/train_lm_torch.py`` runs two steps, and
every script raises without a GPU unless ``--device cpu`` is passed.
"""

import importlib.util
import re
import runpy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import integrand as jint
from repro.core.multifunctions import ZMCMultiFunctions as JZMC

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
RTOL, ATOL = 5e-5, 5e-3
EST_TOL = 1e-2                 # of a standard error
N, TRIALS = 4096 + 301, 2


def _script(name):
    spec = importlib.util.spec_from_file_location(f"{name}_torch",
                                                  EXAMPLES / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _raw(zmc, trials):
    """(trials, n_fn, 2) raw (s1, s2) of each trial, either package."""
    out = []
    for t in range(trials):
        sums = zmc._trial_sums(t, zmc.n_samples, 0)
        out.append(np.stack([np.concatenate([np.asarray(s.s1) for s in sums]),
                             np.concatenate([np.asarray(s.s2) for s in sums])], -1))
    return np.stack(out)


def _hold(zmc, got, jspec, trials, *, seed, use_kernel=False):
    """The port's solver and result against repro's chunked engine on
    ``jspec`` at the same seed; returns repro's result."""
    jzmc = JZMC(jspec, n_samples=zmc.n_samples, seed=seed)
    want = jzmc.evaluate(num_trials=trials)
    assert got.names == want.names and got.means.shape == want.means.shape
    np.testing.assert_allclose(_raw(zmc, trials), _raw(jzmc, trials), rtol=RTOL, atol=ATOL)
    assert np.all(want.stderrs > 0)
    assert np.all(np.abs(got.means - want.means) <= EST_TOL * want.stderrs)
    assert np.all(np.abs(got.stderrs - want.stderrs) <= EST_TOL * want.stderrs)
    assert zmc.use_kernel == use_kernel
    return want


def _printed(pattern, text):
    found = re.findall(pattern, text)
    assert len(found) == 1, (pattern, text[-2000:])
    return found[0]


# -- quickstart ----------------------------------------------------------------

def test_quickstart_matches_reference(capsys):
    zmc, got = _script("quickstart").main(device="cpu", n_samples=N, num_trials=TRIALS)
    out = capsys.readouterr().out
    gauss = jint.IntegrandFamily(
        fn=lambda x, p: jnp.exp(-p["c"] * jnp.sum(jnp.square(x), -1)),
        params={"c": jnp.linspace(0.5, 4.0, 20)},
        domains=jnp.broadcast_to(jnp.asarray([-1.0, 2.0]), (20, 3, 2)),
        name="gauss3d").validate()
    jspec = jint.MultiFunctionSpec.from_families([jint.harmonic_family(50, 4), gauss])
    want = _hold(zmc, got, jspec, TRIALS, seed=0)
    exact = jint.harmonic_analytic(50, 4)
    cover = np.mean(np.abs(want.trial_mean[:50] - exact)
                    <= 2 * np.maximum(want.trial_std[:50], 1e-12))
    assert _printed(r"harmonics inside 2-sigma band: (\d+)%", out) == f"{100 * cover:.0f}"
    assert "first five harmonic modes" in out and "gauss3d first/last" in out


# -- harmonic modes (Fig. 1) -----------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
def test_harmonic_modes_matches_reference(capsys, use_kernel):
    zmc, got, coverage = _script("harmonic_modes").main(
        device="cpu", use_kernel=use_kernel, n_samples=N, num_trials=TRIALS)
    out = capsys.readouterr().out
    want = _hold(zmc, got, [jint.harmonic_family(100, 4)], TRIALS, seed=0, use_kernel=use_kernel)
    pull = np.abs(want.trial_mean - jint.harmonic_analytic(100, 4)) / np.maximum(
        want.trial_std, 1e-12)
    assert coverage == float((pull <= 2).mean())
    assert _printed(r"2-sigma coverage (\S+)", out) == f"{(pull <= 2).mean():.2f}"
    assert len(re.findall(r"^n=\s*\d+ \|", out, re.M)) == 50


# -- Boltzmann collision integrals ----------------------------------------------

def _jgraphs(beam_p):
    """The reference script's two graphs and domains (its jnp code)."""
    T = 1.0

    def thermal(e):
        return jnp.exp(-e / T)

    def gain_s(x, prm):
        q, ct, _ = x[..., 0], x[..., 1], x[..., 2]
        p = prm["p"]
        s_mand = 2 * p * q * (1 - ct) + 0.5
        m2 = jnp.square(s_mand) / (jnp.square(s_mand) + 1.0)
        flux = q * q / (jnp.maximum(p, 1e-3))
        return m2 * flux * thermal(q) * (1 - 0.2 * thermal(p))

    def gain_t(x, prm):
        q, ct, _ = x[..., 0], x[..., 1], x[..., 2]
        p = prm["p"]
        w = 1.0 / jnp.square(2.0 - ct)
        flux = q * q / (jnp.maximum(p, 1e-3))
        return w * flux * thermal(q) * (1 - 0.2 * thermal(p))

    n = len(beam_p)
    dom = np.array([[0.0, 8.0], [-1.0, 1.0], [0.0, 2 * np.pi]], np.float32)
    domains = jnp.asarray(np.broadcast_to(dom, (n, 3, 2)).copy())
    return jint.MultiFunctionSpec.from_families([
        jint.IntegrandFamily(fn=gain_s, params={"p": jnp.asarray(beam_p)},
                             domains=domains, name="graph_s").validate(),
        jint.IntegrandFamily(fn=gain_t, params={"p": jnp.asarray(beam_p)},
                             domains=domains, name="graph_t").validate()])


def test_boltzmann_matches_reference(capsys):
    mod = _script("boltzmann_collision")
    zmc, got = mod.main(device="cpu", n_samples=N, num_trials=TRIALS)
    out = capsys.readouterr().out
    beam_p = np.linspace(0.2, 6.0, mod.N_BEAMS).astype(np.float32)
    _hold(zmc, got, _jgraphs(beam_p), TRIALS, seed=1)
    assert "OK: per-graph collision terms evaluated for all beams in one call" in out
    assert len(re.findall(r"^\s+\d+\.\d\d\s+\S+\s+\S+\s+\(\S+\)$", out, re.M)) == 8


def test_boltzmann_graphs_are_the_reference_graphs():
    """The batched graphs equal the reference's per-function ones on the
    same points."""
    mod = _script("boltzmann_collision")
    beam_p, spec = mod.make_spec(5)
    jspec = _jgraphs(beam_p)
    x = np.random.default_rng(0).uniform(size=(5, 64, 3)).astype(np.float32)
    x = x * np.array([8.0, 2.0, 2 * np.pi], np.float32) + np.array([0.0, -1.0, 0.0], np.float32)
    for fam, jfam in zip(spec.families, jspec.families):
        got = fam.eval_batch(torch.from_numpy(x)).numpy()
        want = np.stack([np.asarray(jfam.fn(jnp.asarray(x[i]), {"p": jfam.params["p"][i]}))
                         for i in range(5)])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- the LM training example ----------------------------------------------------

def test_train_lm_example_runs(capsys, tmp_path):
    _script("train_lm").main(["--steps", "2", "--batch", "2", "--seq", "32",
                              "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert re.search(r"loss \d+\.\d{4} -> \d+\.\d{4} over 2 steps", out), out[-2000:]


# -- the card by default ----------------------------------------------------------

@pytest.mark.parametrize("name", ["quickstart", "harmonic_modes", "boltzmann_collision",
                                  "service_quickstart", "train_lm"])
def test_scripts_raise_without_a_gpu(monkeypatch, name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    monkeypatch.setattr("sys.argv", [f"{name}_torch.py"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runpy.run_path(str(EXAMPLES / f"{name}_torch.py"), run_name="__main__")
