"""Port's boxes, families and Genz suite against repro: parameters bit for
bit, family values within f32 tolerance on the same points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import domains as jdomains
from repro.core import genz as jgenz
from repro.core import integrand as jint
from repro_torch.core import domains, genz, integrand

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

RNG = np.random.default_rng(11)


def _arrays(fam):
    return {k: np.asarray(v) for k, v in fam.params.items()}


def _from_repro(fam, fn=None):
    return integrand.family_from_numpy(fam.kernel, _arrays(fam),
                                       np.asarray(fam.domains), fam.name, fn=fn)


def test_box_volume_affine_finite():
    d = RNG.uniform(-2, 2, (7, 3, 2)).astype(np.float32)
    d.sort(axis=-1)
    dims = np.array([1, 2, 3, 3, 2, 1, 3])
    np.testing.assert_allclose(domains.box_volume(torch.from_numpy(d)).numpy(),
                               np.asarray(jdomains.box_volume(jnp.asarray(d))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        domains.box_volume(torch.from_numpy(d), dims).numpy(),
        np.asarray(jdomains.box_volume(jnp.asarray(d), dims)), rtol=1e-6)
    u = RNG.random((7, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        domains.affine_from_unit(torch.from_numpy(u), torch.from_numpy(d)[:, None]).numpy(),
        np.asarray(jdomains.affine_from_unit(jnp.asarray(u), jnp.asarray(d)[:, None])))
    assert domains.is_finite_box(d) and domains.is_finite_box(torch.from_numpy(d))
    d[0, 0, 1] = np.inf
    assert not domains.is_finite_box(d)
    assert not domains.is_finite_box(torch.from_numpy(d))


@pytest.mark.parametrize("make", [
    lambda m: m.harmonic_family(9, 3),
    lambda m: m.harmonic_family(4, 2, lo=-1.0, hi=2.0),
    lambda m: m.abs_sum_family(5, 3, np.linspace(0.5, 2.0, 5), sign_last=-1.0),
    lambda m: m.gaussian_family(6, 2),
])
def test_stock_families_bit_exact(make):
    want, got = make(jint), make(integrand)
    assert got.name == want.name and got.kernel == want.kernel
    assert (got.n_fn, got.dim) == (want.n_fn, want.dim)
    np.testing.assert_array_equal(got.domains.numpy(), np.asarray(want.domains))
    assert set(got.params) == set(want.params)
    for k in want.params:
        np.testing.assert_array_equal(got.params[k].numpy(), np.asarray(want.params[k]))


def test_analytic_values_equal():
    np.testing.assert_array_equal(integrand.harmonic_analytic(50, 4),
                                  jint.harmonic_analytic(50, 4))
    np.testing.assert_array_equal(integrand.gaussian_analytic(5, 3, half=True),
                                  jint.gaussian_analytic(5, 3, half=True))


@pytest.mark.parametrize("n,dim,seed,difficulty", [
    (7, 1, 0, 9.0), (13, 3, 2, 1.85), (33, 5, 4, 2.04), (5, 8, 123, 7.25)])
def test_genz_params_bit_exact(n, dim, seed, difficulty):
    a, u = genz._params(n, dim, seed, difficulty)
    ja, ju = jgenz._params(n, dim, seed, difficulty)
    assert a.dtype == ja.dtype == np.float32
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(u, ju)


@pytest.mark.parametrize("name", sorted(jgenz.ALL))
def test_genz_families_match(name):
    fam, exact = genz.ALL[name](6, 3)
    jfam, jexact = jgenz.ALL[name](6, 3)
    assert fam.name == jfam.name and fam.kernel == jfam.kernel
    np.testing.assert_array_equal(exact, jexact)
    for k in jfam.params:
        np.testing.assert_array_equal(fam.params[k].numpy(), np.asarray(jfam.params[k]))
    x = RNG.random((6, 64, 3)).astype(np.float32)
    want = np.asarray(jfam.eval_batch(jnp.asarray(x)))
    np.testing.assert_allclose(fam.eval_batch(torch.from_numpy(x)).numpy(), want,
                               rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("make", [
    lambda: jint.harmonic_family(8, 4),
    lambda: jint.abs_sum_family(5, 2, np.ones(5)),
    lambda: jint.gaussian_family(4, 3),
    lambda: jgenz.oscillatory(5, 2)[0],
    lambda: jgenz.corner_peak(5, 4)[0],
])
def test_family_from_numpy_values(make):
    jfam = make()
    fam = _from_repro(jfam)
    x = np.array(jdomains.affine_from_unit(
        jnp.asarray(RNG.random((jfam.n_fn, 128, jfam.dim)), jnp.float32),
        jfam.domains[:, None]))
    want = np.asarray(jax.jit(jfam.eval_batch)(jnp.asarray(x)))
    got = fam.eval_batch(torch.from_numpy(x)).numpy()
    # f32 sums in another order; harmonic phases reach ~40 rad here
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_family_from_numpy_needs_fn_without_kernel():
    jfam = jgenz.product_peak(3, 2)[0]
    with pytest.raises(ValueError, match="pass fn="):
        _from_repro(jfam)
    fam = _from_repro(jfam, fn=genz.product_peak_fn)
    assert fam.kernel is None and fam.n_fn == 3


def test_spec_from_numpy_and_validation():
    jfams = [jint.harmonic_family(5, 2), jint.gaussian_family(3, 4)]
    spec = integrand.spec_from_numpy(
        [dict(kernel=f.kernel, params=_arrays(f), domains=np.asarray(f.domains),
              name=f.name) for f in jfams])
    jspec = jint.MultiFunctionSpec.from_families(jfams)
    assert spec.offsets() == jspec.offsets() and spec.n_fn_total == jspec.n_fn_total
    with pytest.raises(ValueError, match="leading axis"):
        integrand.family_from_numpy("mc_eval_gaussian", {"sigma": np.ones(2)},
                                    np.zeros((3, 1, 2)), "bad")
    with pytest.raises(ValueError, match="lo <= hi"):
        integrand.family_from_numpy("mc_eval_gaussian", {"sigma": np.ones(1)},
                                    np.array([[[1.0, 0.0]]]), "bad")
    with pytest.raises(ValueError, match="at least one"):
        integrand.MultiFunctionSpec.from_families([])
