"""The port's optimizers and schedules (repro_torch.optim) against repro's:
the cases of tests/optim/test_optimizers.py (opt_state_specs waits for the
LM multi-device path), the same gradients fed to both packages for five
steps (AdamW with f32 and with bf16 moments, Adafactor factored and not,
a stage leaf held as a list of per-layer tensors beside plain ones), and
the schedules' values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim import constant as jconstant
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.optim import adafactor, adamw, constant, make_optimizer, warmup_cosine

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


def _quadratic_target():
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((6, 6)).astype(np.float32))
    target = {"w": torch.ones((6, 6)) * 2.0, "b": torch.full((6,), -1.0)}

    def loss(p):
        return (torch.sum(torch.square(p["w"] - target["w"]))
                + torch.sum(torch.square(p["b"] - target["b"])))
    return loss, target, a


def _grad(loss, params):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    g = torch.autograd.grad(loss(leaves), list(leaves.values()))
    return dict(zip(leaves, g))


@pytest.mark.parametrize("kind,lr", [("adamw", 0.05), ("adafactor", 0.1)])
def test_converges_on_quadratic(kind, lr):
    loss, _, _ = _quadratic_target()
    opt = make_optimizer(kind, lr, weight_decay=0.0)
    params = {"w": torch.zeros((6, 6)), "b": torch.zeros((6,))}
    state = opt.init(params)
    for step in range(200):
        params, state = opt.update(_grad(loss, params), state, params, step)
    assert float(loss(params)) < 1e-2, (kind, float(loss(params)))


def test_adafactor_factored_path_converges():
    opt = adafactor(0.1, min_dim_size_to_factor=4)
    target = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32))
    loss = lambda p: torch.sum(torch.square(p["w"] - target))
    params = {"w": torch.zeros((8, 16))}
    state = opt.init(params)
    assert set(state["w"]) == {"vr", "vc"}   # actually factored
    for step in range(300):
        params, state = opt.update(_grad(loss, params), state, params, step)
    assert float(loss(params)) < 1e-2


def test_adamw_weight_decay_shrinks():
    opt = adamw(0.1, weight_decay=0.5)
    params = {"w": torch.full((4, 4), 10.0)}
    state = opt.init(params)
    p2, _ = opt.update({"w": torch.zeros((4, 4))}, state, params, 0)
    assert float(p2["w"].abs().max()) < 10.0


def test_adamw_moment_dtype():
    opt = adamw(0.1, moment_dtype=torch.bfloat16)
    st = opt.init({"w": torch.zeros((2, 2))})
    assert st["mu"]["w"].dtype == torch.bfloat16


def test_adafactor_factored_state_memory():
    opt = adafactor(0.1)
    st = opt.init({"big": torch.zeros((512, 256)), "small": torch.zeros((8,))})
    assert set(st["big"]) == {"vr", "vc"}
    assert st["big"]["vr"].shape == (512,)
    assert st["big"]["vc"].shape == (256,)
    assert set(st["small"]) == {"v"}


def test_warmup_cosine_shape():
    s = warmup_cosine(1.0, 10, 100)
    assert float(s(0)) == 0.0
    assert abs(float(s(10)) - 1.0) < 1e-6
    assert float(s(100)) < float(s(50)) < float(s(10))
    assert float(s(200)) >= 0.1 - 1e-6   # floor


@pytest.mark.parametrize("step", [0, 3, 10, 55, 100, 250])
def test_schedules_match_reference(step):
    """f32 values of the schedules at 0, in the warmup, at its end,
    mid-run, at the end and past it: within one f32 ulp of the reference's
    (the cosine of XLA and of PyTorch may round differently)."""
    got = warmup_cosine(3e-4, 10, 100)(torch.tensor(step, dtype=torch.int32))
    want = np.float32(jwarmup_cosine(3e-4, 10, 100)(jnp.int32(step)))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -23, atol=0)
    assert float(constant(0.5)(step)) == float(jconstant(0.5)(step)) == 0.5


# ---------------------------------------------------------------------------
# the same gradients fed to both packages
# ---------------------------------------------------------------------------

SHAPES = {"w": (160, 144), "b": (9,), "st": (3, 130, 136)}   # "st": a stage leaf
STEPS = 5
# f32: the two packages differ only where XLA and PyTorch round a pow, a
# sqrt or a mean differently (an ulp or two); after five steps parameters
# and state agree to a few ulps of their magnitude.  bf16 moments: XLA keeps
# f32 between the fused ops of a moment's update (b1 * mu + (1 - b1) * g)
# where the port rounds each op to bf16, as the reference's code spells it,
# so moments differ by a bf16 ulp (2^-8 relative) and parameters by that
# fraction of an update (lr 1e-2 here)
TOL = {"float32": dict(state=1e-5, params=1e-6),
       "bfloat16": dict(state=2 ** -7, params=2e-4)}


def _port_tree(arrays):
    """Torch tensors; the stage leaf as a list of its layers."""
    return {k: ([torch.from_numpy(np.array(a)) for a in v] if k == "st"
                else torch.from_numpy(np.array(v))) for k, v in arrays.items()}


def _stacked(leaf):
    return torch.stack(leaf) if isinstance(leaf, list) else leaf


def _assert_close(got, want, tol, what):
    got = _stacked(got).float().numpy()
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("case", ["adamw_f32", "adamw_bf16", "adafactor_factored",
                                  "adafactor_unfactored"])
def test_same_gradients_five_steps_match_reference(case):
    rng = np.random.default_rng(7)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    tsched, jsched = warmup_cosine(1e-2, 2, 10), jwarmup_cosine(1e-2, 2, 10)
    md = "bfloat16" if case == "adamw_bf16" else "float32"
    if case.startswith("adamw"):
        topt = adamw(tsched, moment_dtype=getattr(torch, md))
        jopt = jadamw(jsched, moment_dtype=getattr(jnp, md))
    else:
        factor = 128 if case == "adafactor_factored" else 1024
        topt = adafactor(tsched, min_dim_size_to_factor=factor, weight_decay=0.01)
        jopt = jadafactor(jsched, min_dim_size_to_factor=factor, weight_decay=0.01)
    tp, jp = _port_tree(p0), {k: jnp.asarray(v) for k, v in p0.items()}
    ts, js = topt.init(tp), jopt.init(jp)
    jupdate = jax.jit(jopt.update)
    for step in range(STEPS):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
        jp, js = jupdate({k: jnp.asarray(v) for k, v in g.items()}, js, jp, jnp.int32(step))
        tp2, ts = topt.update(_port_tree(g), ts, tp, torch.tensor(step, dtype=torch.int32))
        assert tp2 is tp and all(a is b for a, b in zip(tp["st"], tp2["st"]))   # in place
    tol = TOL[md]
    for k in SHAPES:
        _assert_close(tp[k], jp[k], tol["params"], f"params/{k}")
    jflat = jax.tree_util.tree_flatten_with_path(js)[0]
    for path, want in jflat:
        keys = [p.key for p in path]
        got = ts
        for key in keys:
            got = got[key]
        assert got.dtype == getattr(torch, str(want.dtype)), keys
        _assert_close(got, want, tol["state"], "/".join(keys))
    if case == "adafactor_factored":
        assert set(ts["w"]) == {"vr", "vc"} and set(ts["st"]) == {"vr", "vc"}
        assert ts["st"]["vr"].shape == (3, 130)        # the stacked leaf's factors
    if case == "adafactor_unfactored":
        assert all(set(v) == {"v"} for v in ts.values())


def test_stage_leaf_is_one_stacked_leaf():
    """Adafactor's update clip takes the RMS over the reference's stacked
    leaf: a list leaf updated as one equals the stacked tensor updated,
    and differs from its layers updated as separate leaves (the second
    step's gradient is 100 times larger in one layer, whose update alone
    then exceeds the clip)."""
    rng = np.random.default_rng(3)
    p = rng.standard_normal((3, 4, 5)).astype(np.float32)
    grads = [rng.standard_normal((3, 4, 5)).astype(np.float32) for _ in range(2)]
    grads[1][0] *= 100.0
    opt = adafactor(0.1)

    def run(split):
        params = split(p.copy())
        state = opt.init(params)
        for step, g in enumerate(grads):
            opt.update(split(g), state, params, step)
        return params

    as_list = run(lambda a: {"st": [torch.from_numpy(x) for x in a]})
    whole = run(lambda a: {"st": torch.from_numpy(a)})
    apart = run(lambda a: {str(i): torch.from_numpy(a[i]) for i in range(3)})
    assert torch.equal(torch.stack(as_list["st"]), whole["st"])
    assert not torch.equal(torch.stack([apart[str(i)] for i in range(3)]), whole["st"])


def test_adamw_is_the_reference_expression_bit_for_bit():
    """The in-place AdamW update equals the reference's expression
    transcribed op for op (out of place, f32) bit for bit: the decay
    inside the update, mu_hat / (sqrt(nu_hat) + eps) + wd * p, then
    p - lr * upd; torch.optim.AdamW's p *= 1 - lr * wd differs."""
    rng = np.random.default_rng(11)
    p0 = rng.standard_normal((64, 48)).astype(np.float32) * 3
    b1, b2, eps, wd, lr = 0.9, 0.95, 1e-8, 0.1, 1e-2
    opt = adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=wd)
    params = {"w": torch.from_numpy(p0.copy())}
    state = opt.init(params)
    p, mu, nu = torch.from_numpy(p0.copy()), torch.zeros(64, 48), torch.zeros(64, 48)
    for step in range(4):
        g = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
        opt.update({"w": g}, state, params, step)
        stepf = torch.tensor(step, dtype=torch.float32) + 1.0
        c1, c2 = 1.0 - torch.pow(b1, stepf), 1.0 - torch.pow(b2, stepf)
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        upd = (mu / c1) / (torch.sqrt(nu / c2) + eps)
        upd = upd + wd * p
        p = p - torch.tensor(lr, dtype=torch.float32) * upd
    assert torch.equal(params["w"], p)
    assert torch.equal(state["mu"]["w"], mu) and torch.equal(state["nu"]["w"], nu)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adafactor_is_the_reference_expression_bit_for_bit(dtype):
    """The Adafactor update equals the reference's expression transcribed op
    for op (out of place) bit for bit: a factored leaf, a stage leaf stacked
    from its layers, an unfactored one; f32 and bf16 parameters; weight
    decay."""
    rng = np.random.default_rng(12)
    dt = getattr(torch, dtype)
    shapes = {"w": (160, 140), "st": (3, 130, 150), "b": (40,)}
    p0 = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt)
          for k, s in shapes.items()}
    eps, decay, wd, lr = 1e-30, 0.8, 0.01, 1e-2
    opt = adafactor(lr, weight_decay=wd)
    params = {k: (list(v.clone().unbind(0)) if k == "st" else v.clone()) for k, v in p0.items()}
    state = opt.init(params)
    ref = {k: v.clone() for k, v in p0.items()}
    ref_s = {k: ({"vr": torch.zeros(s[:-1]), "vc": torch.zeros(s[:-2] + s[-1:])}
                 if len(s) >= 2 else {"v": torch.zeros(s)}) for k, s in shapes.items()}
    for step in range(3):
        grads = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt)
                 for k, s in shapes.items()}
        opt.update({k: (list(g.unbind(0)) if k == "st" else g) for k, g in grads.items()},
                   state, params, step)
        beta = 1.0 - torch.pow(torch.tensor(step, dtype=torch.float32) + 1.0, -decay)
        for k, g in grads.items():
            gf, s = g.float(), ref_s[k]
            g2 = torch.square(gf) + eps
            if "vr" in s:
                s["vr"] = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                s["vc"] = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                row_mean = torch.mean(s["vr"], dim=-1, keepdim=True)
                pre = (s["vr"] / torch.clamp(row_mean, min=eps))[..., None] * s["vc"][..., None, :]
                upd = gf / torch.sqrt(torch.clamp(pre, min=eps))
            else:
                s["v"] = beta * s["v"] + (1 - beta) * g2
                upd = gf / torch.sqrt(torch.clamp(s["v"], min=eps))
            upd = upd / torch.clamp(torch.sqrt(torch.mean(torch.square(upd)) + 1e-30), min=1.0)
            pf = ref[k].float()
            ref[k] = (pf - torch.tensor(lr) * (upd + wd * pf)).to(dt)
    assert torch.equal(torch.stack(params["st"]), ref["st"])
    assert torch.equal(params["w"], ref["w"]) and torch.equal(params["b"], ref["b"])
    for k, s in ref_s.items():
        assert all(torch.equal(state[k][n], v) for n, v in s.items()), k
