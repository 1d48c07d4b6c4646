"""The port's MoE feed-forward (repro_torch.models.moe) against repro's on the
same numpy inputs and weights, in f32: the router's choices equal and its
weights within 1e-6; moe_ffn within the reference's atol=2e-5
(tests/models/test_moe.py) at a dropless capacity and at two that drop,
with the same (token, expert) pairs kept; a call above MOE_CHUNK tokens
routed chunk by chunk; the shared experts; the expert MLP's bf16 silu
steps; two calls bit-equal; the expert-parallel island on two ranks; the
DeepSeek trees (the moe stage, the mtp subtree) carried bit for bit."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JConfig
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, reduced
from repro_torch.launch import multihost
from repro_torch.models import layers, moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import Model

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ATOL = 2e-5
D, T = 16, 64


def _cfgs(**kw):
    base = dict(name="m", family="moe", n_layers=1, d_model=D, n_heads=2, n_kv_heads=2,
                head_dim=8, d_ff=32, vocab_size=64, n_experts=8, top_k=2, moe_d_ff=8,
                n_shared_experts=0, capacity_factor=4.0,     # = E/k: dropless
                param_dtype="float32", compute_dtype="float32", remat="none")
    base.update(kw)
    return JConfig(**base), ModelConfig(**base)


def np_params(defs, rng):
    """Numpy weights for a reference PSpec tree, by the reference's rule
    (normal with std ``scale`` or 1/sqrt(shape[-2]); ones; zeros)."""
    if isinstance(defs, dict):
        return {k: np_params(v, rng) for k, v in defs.items()}
    if defs.init != "normal":
        return (np.ones if defs.init == "ones" else np.zeros)(defs.shape, np.float32)
    fan_in = defs.shape[-2] if len(defs.shape) >= 2 else defs.shape[-1]
    std = defs.scale if defs.scale is not None else fan_in ** -0.5
    return (std * rng.standard_normal(defs.shape)).astype(np.float32)


def both(tree):
    """A numpy tree as a jax tree and a torch tree."""
    if isinstance(tree, dict):
        pairs = {k: both(v) for k, v in tree.items()}
        return ({k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(np.array(tree))


def _setup(seed=0, t=T, skew=0.0, **kw):
    """(reference cfg, port cfg, params as jax and torch, x (1, t, D) as jax
    and torch).  ``skew`` adds a common direction to every token, so the
    router favours a few experts and a capacity drops pairs."""
    jcfg, cfg = _cfgs(**kw)
    rng = np.random.default_rng(seed)
    jp, tp = both(np_params(jmoe.moe_defs(jcfg), rng))
    x = rng.standard_normal((1, t, D)) + skew * rng.standard_normal(D)
    jx, tx = both(x.astype(np.float32))
    return jcfg, cfg, jp, tp, jx, tx


_ref_route = jax.jit(jmoe._route, static_argnums=(2,))
_ref_ffn = jax.jit(jmoe.moe_ffn, static_argnums=(2,))
_ref_dispatch = jax.jit(jmoe._dispatch_compute_combine, static_argnums=(6, 7, 8))


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=0,
                               atol=atol)


def test_moe_defs_equal_reference():
    jcfg, cfg = _cfgs(n_shared_experts=2)
    flat = lambda t: {k: (v.shape, v.axes, v.init, v.scale) if not isinstance(v, dict)
                      else flat(v) for k, v in t.items()}
    assert flat(moe.moe_defs(cfg)) == flat(jmoe.moe_defs(jcfg))
    assert moe.moe_defs(cfg)["shared"]["wg"].shape == (D, 2 * 8)


@pytest.mark.parametrize("experts,top_k", [(8, 2), (64, 6), (256, 8)])
def test_route_matches_reference(experts, top_k):
    """deepseek-v2-lite's 64 experts top-6 and v3's 256 top-8 among them."""
    jcfg, cfg, jp, tp, jx, tx = _setup(seed=experts, n_experts=experts, top_k=top_k)
    jw, jidx = _ref_route(jx[0], jp["router"], jcfg)
    w, idx = moe._route(tx[0], tp["router"], cfg)
    assert idx.shape == (T, top_k) and w.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(w, jw, atol=1e-6)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


def _kept_pairs(dispatch, x_flat, idx, k):
    """(T, k) booleans: pair (token, choice j) kept, read from a dispatch
    function's own output with weight one on choice j alone (a dropped pair
    contributes exactly zero)."""
    out = []
    for j in range(k):
        onehot = np.zeros(idx.shape, np.float32)
        onehot[:, j] = 1.0
        out.append(np.asarray(dispatch(onehot)).any(axis=-1))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("factor", [4.0, 1.25, 0.25])
def test_moe_ffn_matches_reference_with_drops(factor):
    """T = 64 tokens over 8 experts top-2: dropless at 4.0 (= E/k); at 1.25
    (24 rows per expert) and 0.25 (8, the floor) the skewed router overflows
    its favourites, and the same pairs are dropped as in the reference."""
    jcfg, cfg, jp, tp, jx, tx = _setup(seed=1, skew=1.5, capacity_factor=factor)
    _close(moe.moe_ffn(tx, tp, cfg), _ref_ffn(jx, jp, jcfg))

    jw, jidx = _ref_route(jx[0], jp["router"], jcfg)
    idx = torch.from_numpy(np.array(jidx)).long()
    ref_kept = _kept_pairs(lambda w: _ref_dispatch(jx[0], jnp.asarray(w), jidx, jp["wg"],
                                                   jp["wu"], jp["wd"], jcfg, None, 1),
                           tx[0], idx, cfg.top_k)
    got_kept = _kept_pairs(lambda w: moe._dispatch_compute_combine(
        tx[0], torch.from_numpy(w), idx, tp["wg"], tp["wu"], tp["wd"], cfg).numpy(),
        tx[0], idx, cfg.top_k)
    np.testing.assert_array_equal(got_kept, ref_kept)
    # the plan's own keep, back in (token, choice) order, says the same
    cap, order, _, keep = moe.dispatch_plan(idx, cfg)
    plan_kept = torch.empty_like(keep)
    plan_kept[order] = keep
    np.testing.assert_array_equal(plan_kept.reshape(T, cfg.top_k).numpy(), got_kept)
    dropped = int((~got_kept).sum())
    if factor == 4.0:
        assert cap >= T and dropped == 0
    else:
        assert cap == (24 if factor == 1.25 else 8) and dropped > 0


def test_chunked_call_matches_reference(monkeypatch):
    """4296 tokens at d = 16: two chunks of MOE_CHUNK, the second
    zero-padded, each routed and dispatched on its own."""
    t = moe.MOE_CHUNK + 200
    jcfg, cfg, jp, tp, jx, tx = _setup(seed=2, t=t, capacity_factor=1.25)
    routed = []
    route = moe._route
    monkeypatch.setattr(moe, "_route", lambda x, w, c: routed.append(x.shape) or route(x, w, c))
    got = moe.moe_ffn(tx, tp, cfg)
    assert routed == [(moe.MOE_CHUNK, D)] * 2 and got.shape == (1, t, D)
    _close(got, _ref_ffn(jx, jp, jcfg))


def test_shared_experts_added():
    jcfg, cfg, jp, tp, jx, tx = _setup(seed=3, n_shared_experts=2)
    got = moe.moe_ffn(tx, tp, cfg)
    _close(got, _ref_ffn(jx, jp, jcfg))
    routed = moe.moe_ffn(tx, {k: v for k, v in tp.items() if k != "shared"},
                         cfg.with_overrides(n_shared_experts=0))
    assert torch.equal(got, routed + layers.mlp(tx, tp["shared"], cfg))


def _bf16_case(seed=4):
    jcfg, cfg, jp, tp, jx, tx = _setup(seed=seed, compute_dtype="bfloat16",
                                       capacity_factor=1.25, skew=1.5)
    jxb, txb = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    ref = np.asarray(jmoe.moe_ffn(jxb, jp, jcfg).astype(jnp.float32))
    return cfg, tp, txb, ref


def test_expert_silu_follows_the_reference_in_bf16(monkeypatch):
    """In bf16 the expert MLP's silu is the reference's steps
    (layers._silu): the output equals the reference's in nearly every
    element, and F.silu in its place moves many."""
    cfg, tp, txb, ref = _bf16_case()
    got = moe.moe_ffn(txb, tp, cfg)
    assert got.dtype == torch.bfloat16
    same = (got.float().numpy() == ref).mean()
    monkeypatch.setattr(layers, "_silu", torch.nn.functional.silu)
    other = (moe.moe_ffn(txb, tp, cfg).float().numpy() == ref).mean()
    assert same > 0.99 and other < same - 0.05, (same, other)


def test_bf16_combine_adds_experts_in_ascending_order():
    """Top-6 (deepseek-v2-lite's k) in bf16: each token's six weighted
    expert rows are added one by one in ascending expert order, the order
    of the reference's segment_sum, so the outputs are the reference's bits
    (adding them in the router's order moves about half of them)."""
    jcfg, cfg, jp, tp, jx, tx = _setup(seed=8, compute_dtype="bfloat16", top_k=6,
                                       capacity_factor=8 / 6, skew=0.5)
    ref = np.asarray(jmoe.moe_ffn(jx.astype(jnp.bfloat16), jp, jcfg).astype(jnp.float32))
    got = moe.moe_ffn(tx.to(torch.bfloat16), tp, cfg).float().numpy()
    assert (got == ref).mean() > 0.99


def test_two_calls_bit_equal():
    cfg, tp, txb, _ = _bf16_case(seed=5)
    a = moe.moe_ffn(txb, tp, cfg)
    assert torch.equal(a, moe.moe_ffn(txb, tp, cfg))
    _, cfg32, _, tp32, _, tx = _setup(seed=5, capacity_factor=0.25)
    assert torch.equal(moe.moe_ffn(tx, tp32, cfg32), moe.moe_ffn(tx, tp32, cfg32))


def _ep_ranks(x, params, kw):
    from repro_torch.launch.mesh import make_mesh_for
    cfg = _cfgs(**kw)[1]
    mesh = make_mesh_for(model_parallel=2, device="cpu")
    return moe.moe_ffn(x, params, cfg, mesh=mesh).numpy()


def test_expert_parallel_axis_refused_by_name():
    """The expert-parallel axis runs: on a (1, 2) mesh of two gloo ranks
    each rank routes half the tokens to its 4 of 8 experts through the
    all-to-alls, and at a dropless capacity every rank's output equals one
    device's within ATOL.  A model axis of one rank, or one that does not
    divide the experts, is the reference's single-device path."""
    _, cfg, _, tp, _, tx = _setup(seed=6)
    want = moe.moe_ffn(tx, tp, cfg)
    for got in multihost.spawn(_ep_ranks, 2, tx, tp, {}, device="cpu", timeout=120):
        _close(torch.from_numpy(got), want.numpy())
    mesh = lambda shape: SimpleNamespace(mesh_dim_names=("data", "model"), shape=shape)
    for shape in ((4, 1), (1, 3)):
        assert torch.equal(moe.moe_ffn(tx, tp, cfg, mesh=mesh(shape)), want)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v3-671b",
                                  "stablelm-3b", "zamba2-7b"])
def test_ep_role_marks_the_moe_layers_leaves(arch):
    """``ep_role`` names the routed experts' weights ``local`` and the
    router ``router`` in exactly the model's MoE layers, and only under a
    ``model`` axis that divides the experts; every other leaf has no role."""
    cfg = reduced(get_config(arch))
    model = Model(cfg, device="meta")
    mesh = lambda shape: SimpleNamespace(mesh_dim_names=("data", "model"), shape=shape)
    names = [n for n, _ in model.named_parameters()]
    for i, b in enumerate(model.blocks):
        assert moe.is_moe_layer(cfg, i) == getattr(b, "use_moe", False)
    for n in names:
        assert moe.ep_role(cfg, mesh((4, 1)), n) is None
        parts = n.split(".")
        in_moe = parts[0] == "blocks" and getattr(model.blocks[int(parts[1])], "use_moe", False)
        want = None
        if in_moe and parts[2:] in (["ffn", "wg"], ["ffn", "wu"], ["ffn", "wd"]):
            want = "local"
        elif in_moe and parts[2:] == ["ffn", "router"]:
            want = "router"
        assert moe.ep_role(cfg, mesh((2, 2)), n) == want, n
    roles = [moe.ep_role(cfg, mesh((2, 2)), n) for n in names]
    n_moe = sum(moe.is_moe_layer(cfg, i) for i in range(cfg.n_layers))
    assert roles.count("local") == 3 * n_moe and roles.count("router") == n_moe


def test_deepseek_trees_carried_bit_for_bit():
    """Reduced deepseek-v3 stored in bf16: both stages' leaves and the mtp
    subtree reach the port bit for bit; a tree without mtp is refused."""
    jcfg = jreduced(jget_config("deepseek_v3_671b")).with_overrides(param_dtype="bfloat16")
    cfg = reduced(get_config("deepseek_v3_671b")).with_overrides(param_dtype="bfloat16")
    tree = np_params(JModel(jcfg).param_defs(), np.random.default_rng(7))
    tree = jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree)
    model = params_from_reference(tree, Model(cfg, device="cpu"))
    assert [s.name for s in model.stages] == ["dense_layers", "moe_layers"]
    assert [b.use_moe for b in model.blocks] == [False, True, True, True]
    pairs = [(model.blocks[0]["attn"]["wq_b"], tree["stages"]["dense_layers"]["attn"]["wq_b"][0]),
             (model.blocks[2]["ffn"]["wg"], tree["stages"]["moe_layers"]["ffn"]["wg"][1]),
             (model.blocks[3]["ffn"]["shared"]["wd"],
              tree["stages"]["moe_layers"]["ffn"]["shared"]["wd"][2]),
             (model.mtp["proj"], tree["mtp"]["proj"]),
             (model.mtp["block"]["attn"]["wkv_a"], tree["mtp"]["block"]["attn"]["wkv_a"])]
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.detach().float().numpy(), want.astype(np.float32))
    del tree["mtp"]
    with pytest.raises(RuntimeError, match="mtp.proj"):
        params_from_reference(tree, Model(cfg, device="cpu"))
