"""Stratified sampling in the port against repro's: the initial grid,
stratum counters and uniforms bit for bit; per-stratum statistics, the
moment helpers, tree-search refinement and ``ZMCNormal`` within float32
tolerance or a few standard errors; the stratum-moments kernel's plain
version against repro's ``stratum_moments`` (interpret mode) and
``moments_ref`` within the reference test's bounds (count exact, mean
atol=1e-5, M2 rtol=1e-4).

Inputs are made from a seed with numpy; each integrand is written once in
jax.numpy for repro and once in PyTorch for the port.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import adaptive as jad
from repro.core import reduction as jred
from repro.core import rng as jrng
from repro.core import stratified as jstrat
from repro.core import tree_search as jtree
from repro.core.normal import ZMCNormal as JNormal
from repro.kernels.moments.ops import stratum_moments as jstratum_moments
from repro.kernels.moments.ref import moments_ref as jmoments_ref
from repro_torch.core import adaptive, reduction, rng, stratified, tree_search
from repro_torch.core.normal import ZMCNormal
from repro_torch.kernels.moments import ops, ref
from repro_torch.launch.mesh import make_mesh_for

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

KEY = jrng.fold_key(17, 0)


def _jpeak(x):
    return jnp.exp(-50.0 * jnp.sum(jnp.square(x - 0.9), axis=-1))


def _peak(x):
    return torch.exp(-50.0 * torch.sum(torch.square(x - 0.9), dim=-1))


def _jsep(x):
    return jnp.sin(x[..., 0]) * jnp.cos(x[..., 1]) * x[..., 2]


def _sep(x):
    return torch.sin(x[..., 0]) * torch.cos(x[..., 1]) * x[..., 2]


def _matrix(rows, cols, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((rows, cols)).astype(np.float32)
    return (x * np.arange(1, rows + 1, dtype=np.float32)[:, None]
            + np.arange(rows, dtype=np.float32)[:, None])


# -- the table and its counters, bit for bit --------------------------------

@pytest.mark.parametrize("domain,splits,cap", [
    ([[0, 1], [0, 2]], 3, 16), ([[-1, 1], [0.5, 2], [0, 3]], 2, 12)])
def test_initial_grid_bit_exact(domain, splits, cap):
    dom = np.asarray(domain, np.float32)
    t, jt = stratified.initial_grid(dom, splits, cap), jstrat.initial_grid(dom, splits, cap)
    np.testing.assert_array_equal(t.boxes.numpy(), np.asarray(jt.boxes))
    np.testing.assert_array_equal(t.active.numpy(), np.asarray(jt.active))
    np.testing.assert_array_equal(stratified.stratum_volumes(t).numpy(),
                                  np.asarray(jstrat.stratum_volumes(jt)))
    assert stratified.suggested_capacity(3, 3, 8, 32) == \
        jstrat.suggested_capacity(3, 3, 8, 32)
    with pytest.raises(ValueError, match="exceeds capacity"):
        stratified.initial_grid(dom, splits, splits ** len(domain) - 1)


def test_stratum_counters_and_uniforms_bit_exact():
    slots = np.asarray([0, 5, 65535, 70000], np.uint32)
    for epoch in (0, 3, 65535):
        ids = stratified.stratum_ids(slots, epoch)
        want = (slots.astype(np.uint64) + (epoch + 1) * 65536) % 2**32
        np.testing.assert_array_equal(ids.numpy(), want)
        u = rng.uniforms_for(*KEY, ids, np.arange(300), 3)
        ju = jrng.uniforms_for(KEY[0], KEY[1], jnp.asarray(want, jnp.uint32),
                               jnp.arange(300, dtype=jnp.uint32), 3)
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))


# -- per-stratum statistics -------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
def test_eval_strata_vs_reference(use_kernel):
    dom = np.asarray([[0, 1], [0, 1]], np.float32)
    t, jt = stratified.initial_grid(dom, 4, 16), jstrat.initial_grid(dom, 4, 16)
    slots = np.arange(16)
    mean, var = stratified.eval_strata(_peak, t.boxes, slots, 2, 1024, KEY,
                                       use_kernel=use_kernel)
    jmean, jvar = jstrat.eval_strata(_jpeak, jt.boxes, jnp.asarray(slots), 2,
                                     1024, KEY, use_kernel=use_kernel)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-3,
                               atol=1e-7)
    est, err = stratified.table_estimate(t._replace(mean=mean, var=var), 1024)
    jest, jerr = jstrat.table_estimate(jt._replace(mean=jmean, var=jvar), 1024)
    np.testing.assert_allclose([float(est), float(err)],
                               [float(jest), float(jerr)], rtol=1e-4)


def test_region_scores_vs_reference():
    dom = [[0.0, 1.0], [0.0, 1.0]]
    boxes, scores = adaptive.region_scores(_peak, dom, KEY, splits_per_dim=3,
                                           n_per=512, device="cpu")
    jboxes, jscores = jad.region_scores(_jpeak, dom, KEY, splits_per_dim=3,
                                        n_per=512)
    np.testing.assert_array_equal(boxes, jboxes)
    np.testing.assert_allclose(scores, jscores, rtol=1e-3, atol=1e-8)


# -- the moments kernel's plain version and the helpers -----------------------

@pytest.mark.parametrize("rows", [1, 8, 13, 19])
@pytest.mark.parametrize("cols", [512, 2048])
def test_stratum_moments_plain_vs_reference(rows, cols):
    x = _matrix(rows, cols, rows * 100 + cols)
    got = ops.stratum_moments(torch.from_numpy(x))
    for want in (jstratum_moments(jnp.asarray(x)), jmoments_ref(jnp.asarray(x))):
        want = (want if isinstance(want, jred.Moments) else
                jred.Moments(count=want[:, 0], mean=want[:, 1], m2=want[:, 2]))
        np.testing.assert_allclose(got.count.numpy(), np.asarray(want.count),
                                   rtol=0, atol=0)
        np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                                   atol=1e-5)
        np.testing.assert_allclose(got.m2.numpy(), np.asarray(want.m2),
                                   rtol=1e-4)
    oracle = ref.moments_ref(torch.from_numpy(x))
    np.testing.assert_allclose(got.m2.numpy(), oracle[:, 2].numpy(), rtol=1e-4)
    np.testing.assert_allclose(got.variance.numpy(),
                               np.var(x.astype(np.float64), axis=1, ddof=1),
                               rtol=1e-4)


def test_stratum_moments_rejects_ragged_columns():
    for bad in (torch.zeros(4, ops.C_BLK + 1), torch.zeros(4, 0),
                torch.zeros(ops.C_BLK)):
        with pytest.raises(ValueError):
            ops.stratum_moments(bad)
    with pytest.raises(ValueError):
        ops.moments_cuda(torch.zeros(8, ops.C_BLK))      # a CPU tensor


def test_reduction_helpers_vs_reference():
    r = np.random.default_rng(3)
    a = [r.uniform(1, 9, 5).astype(np.float32) for _ in range(3)]
    b = [r.uniform(1, 9, 5).astype(np.float32) for _ in range(3)]
    got = reduction.moments_combine(
        reduction.Moments(*map(torch.from_numpy, a)),
        reduction.Moments(*map(torch.from_numpy, b)))
    want = jred.moments_combine(jred.Moments(*map(jnp.asarray, a)),
                                jred.Moments(*map(jnp.asarray, b)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    np.testing.assert_allclose(got.variance.numpy(), np.asarray(want.variance),
                               rtol=1e-6)
    s1, s2 = r.uniform(0, 5, 4).astype(np.float32), r.uniform(30, 50, 4).astype(np.float32)
    for g, w in zip(reduction.moments_from_sums(7.0, torch.from_numpy(s1),
                                                torch.from_numpy(s2)),
                    jred.moments_from_sums(7.0, jnp.asarray(s1), jnp.asarray(s2))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    x = r.standard_normal((3, 37)).astype(np.float32)
    np.testing.assert_array_equal(reduction.pairwise_sum(torch.from_numpy(x)).numpy(),
                                  np.asarray(jred.pairwise_sum(jnp.asarray(x))))
    acc, jacc = reduction.kahan_zero((3,)), jred.kahan_zero((3,))
    for col in x.T:
        acc = reduction.kahan_add(acc, torch.from_numpy(col))
        jacc = jred.kahan_add(jacc, jnp.asarray(col))
    np.testing.assert_array_equal(acc.total.numpy(), np.asarray(jacc.total))
    z = reduction.moments_zero((2,))
    assert all(float(v.abs().sum()) == 0.0 for v in z)


# -- tree search --------------------------------------------------------------

def _separated_table():
    """A 4x4 table over the unit square evaluated at epoch 0, whose
    priorities are well apart (no near-ties in the top-k)."""
    dom = np.asarray([[0, 1], [0, 1]], np.float32)
    cap = stratified.suggested_capacity(2, 4, 3, 4)
    t, jt = stratified.initial_grid(dom, 4, cap), jstrat.initial_grid(dom, 4, cap)
    m, v = stratified.eval_strata(_peak, t.boxes[:16], np.arange(16), 0, 512, KEY)
    jm, jv = jstrat.eval_strata(_jpeak, jt.boxes[:16], jnp.arange(16), 0, 512, KEY)
    t = t._replace(mean=torch.cat([m, t.mean[16:]]), var=torch.cat([v, t.var[16:]]))
    jt = jt._replace(mean=jt.mean.at[:16].set(jm), var=jt.var.at[:16].set(jv))
    return t, jt


def test_refine_step_by_step_vs_reference():
    t, jt = _separated_table()
    for depth in range(1, 4):
        got = tree_search.refine(_peak, t, KEY, n0=16, n_per=512, depth=depth,
                                 k_split=4)
        want = jtree.refine(_jpeak, jt, KEY, n0=16, n_per=512, depth=depth,
                            k_split=4)
        np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
        np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
        np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var),
                                   rtol=1e-3, atol=1e-7)


def test_tree_search_integrate_vs_reference():
    kw = dict(splits_per_dim=4, n_per=512, depth=6, k_split=8)
    got = tree_search.integrate(_peak, [[0, 1], [0, 1]], KEY, device="cpu", **kw)
    want = jtree.integrate(_jpeak, [[0, 1], [0, 1]], KEY, **kw)
    one_d = math.sqrt(math.pi / 50) / 2 * (math.erf(math.sqrt(50) * 0.9)
                                           + math.erf(math.sqrt(50) * 0.1))
    assert got.n_evals == int(want.n_evals)
    assert abs(float(got.integral) - float(want.integral)) <= \
        3 * (float(got.stderr) + float(want.stderr))
    assert abs(float(got.integral) - one_d ** 2) < 4 * float(got.stderr) + 1e-3
    vols = stratified.stratum_volumes(got.table)[got.table.active]
    np.testing.assert_allclose(float(vols.sum()), 1.0, rtol=1e-5)


# -- ZMCNormal ----------------------------------------------------------------

def test_zmcnormal_vs_reference():
    dom = [[0, np.pi], [0, np.pi / 2], [0, 2.0]]
    opts = dict(splits_per_dim=3, n_per_stratum=1024, depth=4, k_split=16)
    got = ZMCNormal(_sep, dom, seed=5, device="cpu", **opts).evaluate(3)
    want = JNormal(_jsep, dom, seed=5, **opts).evaluate(num_trials=3)
    assert got.trial_values.shape == (3,)
    assert abs(got.integral - 4.0) < 0.02
    for g, w in zip(got.trial_values, want.trial_values):
        assert abs(g - w) <= 3 * (got.stderr + want.stderr)
    assert abs(got.stderr - want.stderr) <= 0.1 * want.stderr


def test_zmcnormal_rejects_infinite_box_and_mesh(tmp_path):
    with pytest.raises(ValueError, match="finite box"):
        ZMCNormal(lambda x: x[..., 0], [[0, np.inf]], device="cpu")
    # the mesh is ported now: a (1, 1) mesh of a world-size-1 gloo group
    # gives the single-device bits, with the plain and the kernel reduction
    opts = dict(splits_per_dim=3, n_per_stratum=512, depth=2, k_split=8)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh_for(device="cpu")
        for use_kernel in (False, True):
            want = ZMCNormal(_sep, [[0, 1]] * 3, seed=4, device="cpu",
                             use_kernel=use_kernel, **opts).evaluate(2)
            got = ZMCNormal(_sep, [[0, 1]] * 3, seed=4, device="cpu",
                            use_kernel=use_kernel, mesh=mesh, **opts).evaluate(2)
            np.testing.assert_array_equal(got.trial_values, want.trial_values)
            assert got.stderr == want.stderr
    finally:
        dist.destroy_process_group()
