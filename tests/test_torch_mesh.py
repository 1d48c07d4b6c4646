"""The port's multi-device path on gloo ranks of the CPU, held against
``repro`` on one CPU device.

Four ranks are spawned once for the (data, model) meshes (2, 2), (4, 1)
and (1, 4) and the (pod, data, model) mesh (2, 2, 1), two for (2, 1), and
two for the (1, 2) mesh with a state dir (held against ``repro``'s
auditor and store, in test_torch_mesh_state.py with the spawn and launcher
tests); each spawn starts its processes with ``multihost.spawn`` and a
``file://`` rendezvous under ``tmp_path``.  The
ranks import only torch and the port; this module imports ``repro`` in
the test process alone (inside the functions that need it), so the ranks
start quickly.

The oracle is ``repro``'s chunked ``family_sums`` on the same counters:
its counters do not depend on the mesh, so a sharded call equals the
single-device one up to f32 association order (the ROADMAP's MC
tolerance rtol=5e-5, atol=5e-3; Sobol rtol=1e-4, atol=1e-2).  ``repro``'s
own mesh runs fail on jax 0.9.0 (Pallas inside ``shard_map``), and its
fused ``eval_plan`` costs over 20 s per interpret-mode compile here; it is
held to ``family_sums`` by ``repro``'s own tests.  Within the port the
bits are exact: every rank holds the same bits, and an R-round sharded
launch equals R single-round sharded launches.
"""

import functools
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import multihost

torch.set_num_threads(1)

N = 4098                     # 4 sample shards of 1025, the last masking 2
R = 4096                     # round quantum
MESHES = ((2, 2), (4, 1), (1, 4), (2, 2, 1))    # (data, model), (pod, data, model)
TOL = {"mc": dict(rtol=5e-5, atol=5e-3), "sobol": dict(rtol=1e-4, atol=1e-2)}
START = {0: 0, 1: 3, 2: 1, 3: 5, 4: 2}       # families at different depths
A20 = np.linspace(0.5, 2.0, 20).astype(np.float32)


def _edges(domains, n_bins=4, seed=0):
    """Strictly increasing per-axis grid edges spanning each box."""
    domains = np.asarray(domains, np.float32)
    n_fn, dim = domains.shape[:2]
    w = np.random.default_rng(seed).uniform(0.5, 1.5, (n_fn, dim, n_bins))
    w = w / w.sum(-1, keepdims=True)
    lo, hi = domains[..., 0:1], domains[..., 1:2]
    cuts = np.concatenate([np.zeros((n_fn, dim, 1)), np.cumsum(w, -1)], -1)
    cuts[..., -1] = 1.0
    return (lo + (hi - lo) * cuts).astype(np.float32)


def _families(integrand, genz):
    """Five fusable families, one bucket of five blocks at dim 2 (plain,
    compactified, swept over two blocks, adapted) and one at dim 3, then a
    family no kernel serves; built alike by both packages."""
    peak = genz.corner_peak(6, 2)[0]
    return [
        integrand.harmonic_family(10, 2),
        integrand.gaussian_family(5, 2, lo=-np.inf, hi=np.inf).compactified(),
        integrand.harmonic_family(1, 2).swept_over({"a": A20}),
        peak.adapted(_edges(np.asarray(peak.domains))),
        integrand.harmonic_family(7, 3),
        genz.continuous(3, 2)[0],
    ]


def _port_families():
    from repro_torch.core import genz, integrand
    return _families(integrand, genz)


def _np(state):
    return np.stack([state.s1.numpy(), state.s2.numpy()], -1)


# -- the ranks ------------------------------------------------------------------

def _four_ranks():
    """Every scenario of the four-rank meshes, as numpy, per mesh shape."""
    torch.set_num_threads(1)
    from repro_torch.core import direct_mc, rng
    from repro_torch.core.integrand import MultiFunctionSpec
    from repro_torch.core.normal import ZMCNormal
    from repro_torch.kernels.mc_eval import multi
    from repro_torch.launch.mesh import make_mesh_for

    fams = _port_families()
    spec = MultiFunctionSpec.from_families(fams[:5])
    offs = MultiFunctionSpec.from_families(fams).offsets()
    key = rng.fold_key(1, 0)
    out = {}
    for shape in MESHES:
        mesh = make_mesh_for(model_parallel=shape[-1], pods=shape[0] if len(shape) == 3 else 1,
                             device="cpu")
        axes = dict(sample_axes=("pod", "data")[-(len(shape) - 1):])
        res = {}
        for sampler in ("mc", "sobol"):
            plan = multi.plan_spec(spec, sampler=sampler)
            got = multi.sharded_eval_plan(plan, N, key, mesh, **axes)
            res[f"plan_{sampler}"] = {i: _np(s) for i, s in got.items()}
            res[f"n_{sampler}"] = {i: float(s.n) for i, s in got.items()}
        plan = multi.plan_spec(spec)
        where, outs = multi.sharded_eval_plan_rounds(plan, R, 2, key, mesh,
                                                     start_rounds=START, **axes)
        res["rounds"] = {i: outs[b][:, row:row + n].numpy()
                         for i, (b, row, n) in where.items()}
        res["rounds_raw"] = [o.numpy() for o in outs]
        res["single_rounds"] = [
            [o[0].numpy() for o in multi.sharded_eval_plan_rounds(
                plan, R, 1, key, mesh,
                start_rounds={i: s + r for i, s in START.items()}, **axes)[1]]
            for r in range(2)]
        chunked, padded = direct_mc.sharded_family_sums(
            fams[5], N, key, mesh, fn_offset=offs[5], **axes)
        res["chunked"] = (_np(chunked), float(chunked.n), padded.n_fn)
        out[shape] = res
    mesh = make_mesh_for(model_parallel=2, device="cpu")
    zn = ZMCNormal(lambda x: torch.sin(x[..., 0]) * torch.cos(x[..., 1]),
                   [[0, np.pi], [0, np.pi / 2]], seed=3, splits_per_dim=4,
                   n_per_stratum=512, depth=4, k_split=8, mesh=mesh, device="cpu")
    out["normal"] = zn.evaluate(num_trials=2).integral
    return out


def _two_ranks(ckpt_dir):
    """The (2, 1) mesh: a checkpoint left by an injected crash, the service
    on the launcher's demo workload, and the engine's checks."""
    torch.set_num_threads(1)
    from repro_torch.core.multifunctions import ZMCMultiFunctions
    from repro_torch.kernels import build, template
    from repro_torch.launch import serve_integrals
    from repro_torch.launch.mesh import make_mesh_for, make_production_mesh, mesh_info
    from repro_torch.service import IntegrationEngine

    mesh = make_mesh_for(model_parallel=1, device="cpu")
    out = {}
    zmc = ZMCMultiFunctions(_port_families(), n_samples=4 * R, seed=5,
                            use_kernel=True, mesh=mesh, device="cpu")
    try:
        zmc.evaluate_resumable(rounds=4, checkpoint_dir=ckpt_dir,
                               fail_after_round=1)
    except RuntimeError as exc:
        out["crash"] = str(exc)
    reqs = serve_integrals.demo_workload(8, n_fn=4, n_samples=2 * R)
    for thread in (False, True):
        engine = IntegrationEngine(round_samples=R, device="cpu", mesh=mesh)
        template.reset_launch_count()
        tickets = [engine.submit(r) for r in reqs]
        if thread:
            engine.start()
            got = [engine.result(t, timeout=120.0) for t in tickets]
            engine.stop()
        else:
            while engine.step():
                pass
            got = [engine.poll(t) for t in tickets]
        out[f"serve_{thread}"] = ([(r.means, r.stderrs) for r in got],
                                  template.launch_count(), engine.stats.waves,
                                  engine.batcher.fallback_rounds)
        engine.close()
    # a state dir pinned to seed 0 by a first engine: a second engine with
    # seed 1 fails on both ranks (rank 0 checks meta.json, rank 1 learns it)
    meta_dir = ckpt_dir + "_meta"
    IntegrationEngine(round_samples=R, device="cpu", mesh=mesh, state_dir=meta_dir).close()
    for kw in (dict(round_samples=R + 1), dict(round_samples=R, seed=1, state_dir=meta_dir)):
        try:
            IntegrationEngine(device="cpu", mesh=mesh, **kw)
        except ValueError as exc:
            out.setdefault("errors", []).append(str(exc))
    try:
        make_production_mesh(device="cpu")
    except RuntimeError as exc:
        out["errors"].append(str(exc))
    out["info"] = mesh_info(mesh)
    # a rank never builds a kernel library it does not find
    lib_path = build._lib_path
    build._lib_path = lambda name: Path(ckpt_dir) / "missing.so"
    try:
        build.load("zmc_missing")
    except RuntimeError as exc:
        out["errors"].append(str(exc))
    finally:
        build._lib_path = lib_path
    return out


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    d = tmp_path_factory.mktemp("four")
    return multihost.spawn(_four_ranks, 4, device="cpu", init_file=str(d / "rendezvous"),
                           timeout=240)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    d = tmp_path_factory.mktemp("two")
    ckpt = d / "ckpt"
    out = multihost.spawn(_two_ranks, 2, str(ckpt), device="cpu",
                          init_file=str(d / "rendezvous"), timeout=240)
    return out, str(ckpt)


# -- the reference on one device -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_sums(sampler, n, *, sample_offset=0, index=None):
    """repro's family_sums of every family (or family ``index``) on the
    port's counters, as (n_fn, 2) numpy (cached: the parametrized tests
    share them)."""
    from repro.core import direct_mc as jdmc
    from repro.core import genz as jgenz
    from repro.core import integrand as jint
    from repro.core import rng as jrng
    fams = _families(jint, jgenz)
    offs = jint.MultiFunctionSpec.from_families(fams).offsets()
    out = {}
    for i, (fam, off) in enumerate(zip(fams, offs)):
        if index is not None and i != index:
            continue
        s = jdmc.family_sums(fam, n, jrng.fold_key(1, 0), fn_offset=off,
                             sample_offset=sample_offset, sampler=sampler)
        out[i] = np.stack([np.asarray(s.s1), np.asarray(s.s2)], -1)
    return out


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


# -- sharded fused buckets ----------------------------------------------------------

@pytest.mark.parametrize("sampler", ["mc", "sobol"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sharded_eval_plan_matches_repro(four, shape, sampler):
    """Every fused family (compactified, swept, adapted blocks in one
    bucket that _shard_bucket pads) against repro at the exact n."""
    want = _ref_sums(sampler, N)
    got = four[0][shape][f"plan_{sampler}"]
    assert sorted(got) == [0, 1, 2, 3, 4]
    for i, g in got.items():
        np.testing.assert_allclose(g, want[i], **TOL[sampler], err_msg=f"family {i}")
    assert set(four[0][shape][f"n_{sampler}"].values()) == {float(N)}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sharded_rounds_match_repro(four, shape):
    """A two-round wave, families at different start rounds, against
    repro's single-device rounds at the same offsets."""
    got = four[0][shape]["rounds"]
    for i, start in START.items():
        for r in range(2):
            want = _ref_sums("mc", R, sample_offset=(start + r) * R, index=i)[i]
            np.testing.assert_allclose(got[i][r], want, **TOL["mc"],
                                       err_msg=f"family {i} round {r}")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_rounds_equal_single_rounds_bit_for_bit(four, shape):
    for rank in four:
        res = rank[shape]
        for b, stack in enumerate(res["rounds_raw"]):
            for r in range(2):
                np.testing.assert_array_equal(_bits(stack[r]),
                                              _bits(res["single_rounds"][r][b]))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_every_rank_holds_the_same_bits(four, shape):
    first = four[0][shape]
    for rank in four[1:]:
        res = rank[shape]
        for what in ("plan_mc", "plan_sobol", "rounds"):
            for i, v in first[what].items():
                np.testing.assert_array_equal(_bits(res[what][i]), _bits(v))
        for a, b in zip(res["rounds_raw"], first["rounds_raw"]):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(_bits(res["chunked"][0]), _bits(first["chunked"][0]))


# -- sharded chunked sums ------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sharded_family_sums_match_repro(four, shape):
    """The chunked sharded path draws ceil(n / P) per sample shard and
    reports that rounded total, as repro's does."""
    sample_par, model = math.prod(shape[:-1]), shape[-1]
    per_shard = -(-N // sample_par)
    sums, n, n_fn_padded = four[0][shape]["chunked"]
    assert n == per_shard * sample_par
    assert n_fn_padded == -(-3 // model) * model
    want = _ref_sums("mc", per_shard * sample_par, index=5)[5]
    np.testing.assert_allclose(sums[:3], want, **TOL["mc"])


def test_zmcnormal_on_mesh(four):
    """repro's distributed ZMCNormal check (prog_sharded_mc.py): within
    0.02 of the analytic 2.0, the same value on every rank."""
    vals = [rank["normal"] for rank in four]
    assert len(set(vals)) == 1
    assert abs(vals[0] - 2.0) < 0.02, vals[0]


# -- checkpoints, the service and the launchers --------------------------------------

def test_checkpoint_from_mesh_resumes_on_one_device(two):
    """evaluate_resumable crashed after round 1 on (2, 1) (rank 0 wrote the
    checkpoint), then resumed on one device: the counters do not depend on
    the mesh, so it matches an uninterrupted single-device run."""
    from repro_torch.core.multifunctions import ZMCMultiFunctions
    out, ckpt = two
    assert all("injected failure after round 1" in o["crash"] for o in out)
    (path,) = [os.path.join(ckpt, f) for f in os.listdir(ckpt)]
    with np.load(path) as data:
        assert int(data["round"]) == 2

    def run(**kw):
        return ZMCMultiFunctions(_port_families(), n_samples=4 * R, seed=5,
                                 use_kernel=True, device="cpu").evaluate_resumable(
                                     rounds=4, **kw)
    resumed, whole = run(checkpoint_dir=ckpt), run()
    np.testing.assert_allclose(resumed.means, whole.means, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(resumed.stderrs, whole.stderrs, rtol=1e-4, atol=1e-6)


def test_engine_on_mesh_serves_the_demo_workload(two):
    """The launcher's demo workload on (2, 1), synchronous and with the
    worker thread: the same bits on both ranks and in both modes, the
    single-device launches (one per bucket per wave), no fallback, and
    the single-device estimates within the MC tolerance."""
    from repro_torch.kernels import template
    from repro_torch.launch import serve_integrals
    from repro_torch.service import IntegrationEngine
    out, _ = two
    reqs = serve_integrals.demo_workload(8, n_fn=4, n_samples=2 * R)
    engine = IntegrationEngine(round_samples=R, device="cpu")
    template.reset_launch_count()
    tickets = [engine.submit(r) for r in reqs]
    while engine.step():
        pass
    want = [engine.poll(t) for t in tickets]
    launches, waves = template.launch_count(), engine.stats.waves
    engine.close()
    sync = out[0]["serve_False"]
    assert sync[1:] == (launches, waves, 0)
    for o in out:
        for mode in ("serve_False", "serve_True"):
            for (m, s), (m0, s0) in zip(o[mode][0], sync[0]):
                np.testing.assert_array_equal(_bits(m), _bits(m0))
                np.testing.assert_array_equal(_bits(s), _bits(s0))
    for (m, s), w in zip(sync[0], want):
        np.testing.assert_allclose(m, w.means, **TOL["mc"])
        np.testing.assert_allclose(s, w.stderrs, **TOL["mc"])


def test_engine_and_mesh_checks(two):
    """The engine's round and state-dir checks (a state dir made with
    another seed fails on every rank), the production mesh's size check,
    mesh_info, and a rank that finds no kernel library."""
    out = two[0][0]
    errors = out["errors"]
    assert "must divide evenly" in errors[0]
    assert all("was created with seed=0" in o["errors"][1] for o in two[0])
    assert "need 256 ranks" in errors[2]
    assert "before starting ranks" in errors[3]
    assert out["info"] == {"axis_names": ("data", "model"),
                           "shape": {"data": 2, "model": 1}, "n_devices": 2}
