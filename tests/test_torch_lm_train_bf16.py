"""The port's train step in the configurations' own dtypes against repro's:
bf16 parameters and gradients (the gradients summed over microbatches in
bf16, the clip cast back to bf16, AdamW and Adafactor computing in f32 and
rounding to the parameter's dtype), one family of each kind.

(a) bf16 parameters with f32 compute, one ``make_train_step`` of each
package from the same weights: the loss, the gradient norm and the updated
parameters within test_torch_lm_train.py's tolerances, the train state's
dtypes the reference's leaf by leaf.  (b) bf16 parameters with bf16
compute, as the configurations run: the loss within BF16_LOSS_RTOL, and
the port's gradient norm no farther from the f32-compute norm of the same
weights than BF16_GNORM_SPREAD times the reference's.  (c) A bf16
``train_loop`` crashed and resumed from its checkpoint, bit for bit
(tests/test_system.py's protocol), its bf16 leaves written as the
reference's ``<V2`` records and read back by the reference's restore.

The weights are drawn once per architecture by the port's seeded init (the
reference's init of these reduced models takes 3-15 s each on the CPU, its
jitted train step another 3-14 s) and handed to the reference as its
parameter tree, to the port through ``params_from_reference``."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.distributed import checkpoint as jckpt
from repro.launch import train as jtrain
from repro.launch.specs import concrete_batch as jconcrete_batch
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.checkpoint import leaf_paths
from repro_torch.launch import train
from repro_torch.models.convert import params_from_reference, reference_params, stack_tree
from repro_torch.models.model import Model

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

# test_torch_lm_train.py's tolerances for one step against the reference
LOSS_RTOL, GNORM_RTOL, PARAM_RMS = 1e-5, 1e-3, 1e-2
# test_torch_lm_grads.py's per-leaf rule: the largest |diff| of a leaf's
# gradient within GRAD_REL of its largest |g|
GRAD_REL = 2e-3
# Leaves held by their gradient, not by their parameters, under (a).  The
# zero-initialised key bias: adding it shifts every score of a query by the
# same amount but for RoPE's rotation, so where the rotation is near the
# identity its gradient is rounding noise, and Adam's normalised first
# step turns that noise into +-lr.  qwen2-vl's bk lay 7.4e-3 from the
# reference's by relative RMS here (1.16e-2 from the reference's own init;
# every other leaf of the seven cases within 1e-3), its gradient 1.7e-4 of
# its largest |g|
GRAD_GATED = {"qwen2_vl_7b": ("params/stages/layers/attn/bk",)}
# (b): in bf16 compute the two packages round in other places (XLA fuses the
# reference's norms and keeps their products in f32): the loss lay at most
# 3.0e-4 apart (zamba2-7b; the others 1.3e-5 to 1.2e-4), the gradient norms
# up to 4% (stablelm-3b: 29.67 against 28.52, 15.66 in f32 compute).  The
# witness that the port's bf16 rounding is no worse than the reference's:
# the port's norm no farther from the f32-compute norm than
# BF16_GNORM_SPREAD times the reference's (0.92 to 1.43 measured, the
# largest mamba2-130m's, whose bf16 norms lie within 0.4% of its f32 one)
BF16_LOSS_RTOL, BF16_GNORM_SPREAD = 5e-4, 1.5

# one family of each kind: (arch, hyperparameters: step 25's AdamW, or
# deepseek-v3's own recipe: Adafactor, 4 microbatches, MTP, bf16 moments)
CASES = [
    pytest.param("stablelm_3b", "adamw", id="stablelm_3b"),                    # dense
    pytest.param("deepseek_v2_lite_16b", "adamw", id="deepseek_v2_lite_16b"),  # MoE, MLA
    pytest.param("zamba2_7b", "adamw", id="zamba2_7b"),     # hybrid: the shared block
    pytest.param("mamba2_130m", "adamw", id="mamba2_130m"),  # SSM: A_log, dt_bias in bf16
    pytest.param("hubert_xlarge", "adamw", id="hubert_xlarge"),                # encoder
    pytest.param("qwen2_vl_7b", "adamw", id="qwen2_vl_7b"),  # VLM: vision splice, M-RoPE
    pytest.param("deepseek_v3_671b", "recipe", id="deepseek_v3_671b-recipe"),
]


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b ** 2)), 1e-30))


def _hparams(cfg, opt: str) -> dict:
    over = dict(optimizer="adamw", warmup_steps=0, total_steps=10, grad_accum=2, lr=1e-3)
    if opt == "recipe":
        recipe = train.default_hparams_for(cfg)
        over.update(optimizer=recipe.optimizer, grad_accum=recipe.grad_accum,
                    weight_decay=recipe.weight_decay)
        assert over["optimizer"] == "adafactor" and over["grad_accum"] == 4
    return over


def _configs(arch: str, compute: str):
    over = dict(param_dtype="bfloat16", compute_dtype=compute)
    return (jreduced(jget_config(arch)).with_overrides(**over),
            reduced(get_config(arch)).with_overrides(**over))


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@functools.lru_cache(maxsize=None)
def _weights(arch: str) -> dict:
    """The architecture's bf16 weights (the port's seeded init), as the
    reference's parameter tree of numpy arrays."""
    _, cfg = _configs(arch, "float32")
    return jax.tree.map(lambda t: _np(t.detach()), reference_params(Model(cfg, device="cpu",
                                                                          seed=0)))


def _torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def reference_grads(jm, jhp, params, batch):
    """The reference step's gradients before the clip, its expression
    written out: each microbatch's gradient summed in the parameters'
    dtype, times 1/accum."""
    acc = None
    for i in range(jhp.grad_accum):
        mb = jax.tree.map(lambda v: v[i], jtrain._split_microbatches(batch, jhp.grad_accum))
        g = jax.grad(lambda p: jm.loss(p, mb)[0])(params)
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
    return jax.tree.map(lambda g: g * (1.0 / jhp.grad_accum), acc)


def _port_step(arch: str, opt: str, compute: str, batch: dict, gated=()):
    """One port step from the architecture's weights on ``batch`` (the
    reference's arrays): (state, metrics, each leaf of ``gated``'s gradient
    before the clip)."""
    _, cfg = _configs(arch, compute)
    hp = train.TrainHParams(**_hparams(cfg, opt))
    model = params_from_reference(_weights(arch), Model(cfg, device="cpu"))
    state = train.make_train_state(model, hp)
    step = train.make_train_step(model, hp)
    with train.deterministic("cpu"):        # step(state, batch), phase by phase
        metrics = step.grads(state, {k: _torch(v) for k, v in batch.items()})
        grads = {f"params/{n}": g for n, g in leaf_paths(grads_tree(state["params"]))
                 if f"params/{n}" in gated}
        metrics["grad_norm"] = step.clip(state)
        step.apply(state)
    return state, metrics, grads


def _one_step(arch: str, opt: str, compute: str, gated=()):
    """One step of each package from the same weights on the same batch:
    (the reference's state and metrics, the port's, and each gated leaf's
    gradient before the clip as (port, reference))."""
    jcfg, cfg = _configs(arch, compute)
    jhp = dataclasses.replace(jtrain.TrainHParams(), **_hparams(cfg, opt))
    jm = JModel(jcfg)
    params = jax.tree.map(jnp.asarray, _weights(arch))
    jstate = {"params": params, "opt": jtrain._make_opt(jcfg, jhp).init(params),
              "step": jnp.zeros((), jnp.int32)}
    jb = jconcrete_batch(jcfg, 4, 16, train=True, seed=3)
    state, metrics, grads = _port_step(arch, opt, compute, jb, gated)
    pairs = {}
    if gated:
        jgrads = dict(leaf_paths(jax.jit(functools.partial(reference_grads, jm, jhp))(
            params, jb)))
        pairs = {n: (g, np.asarray(jgrads[n.removeprefix("params/")])) for n, g in grads.items()}
    jstate, jmetrics = jax.jit(jtrain.make_train_step(jm, jhp))(jstate, jb)
    return jstate, jmetrics, state, metrics, pairs, jb


def grads_tree(tree):
    """The gradients of a parameter tree in the reference's layout (copies)."""
    if isinstance(tree, dict):
        return {k: grads_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return torch.stack([t.grad for t in tree])
    return tree.grad.clone()


def _same_layout(jstate, state) -> tuple[dict, dict]:
    """The port's state and the reference's, leaf name -> array, after
    checking the two have the same leaves, shapes and dtypes."""
    got = dict(leaf_paths(stack_tree(state)))
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jstate))[0]
    want = {"/".join(str(k.key) for k in p): w for p, w in flat}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(w.dtype), name
    return got, want


def check_f32_compute(arch: str, opt: str) -> None:
    """(a) bf16 parameters and gradients, f32 compute: the loss, the
    gradient norm and the updated parameters within
    test_torch_lm_train.py's tolerances, each leaf of GRAD_GATED by its
    gradient before the clip (test_torch_lm_grads.py's rule); the state's
    leaves, shapes and dtypes the reference's (bf16 parameters; v3's bf16
    moments, Adafactor's f32 statistics)."""
    gated = GRAD_GATED.get(arch, ())
    jstate, jmetrics, state, metrics, pairs, _ = _one_step(arch, opt, "float32", gated)
    assert set(jmetrics) <= set(metrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=GNORM_RTOL if k == "grad_norm" else LOSS_RTOL,
                                   err_msg=k)
    got, want = _same_layout(jstate, state)
    assert int(got["step"]) == 1
    params = [n for n in want if n.startswith("params/")]
    assert all(got[n].dtype == torch.bfloat16 for n in params)
    assert sorted(pairs) == sorted(gated)
    for name in params:
        if name in gated:
            g, w = pairs[name]
            w = w.astype(np.float32)
            assert g.dtype == torch.bfloat16 and float(np.abs(w).max()) > 0, name
            np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                       atol=GRAD_REL * float(np.abs(w).max()), err_msg=name)
        elif want[name].size:
            assert rel_rms(got[name].float().numpy(), want[name].astype(np.float32)) \
                < PARAM_RMS, name


def check_bf16_compute(arch: str, opt: str) -> None:
    """(b) bf16 parameters and gradients, bf16 compute (as the
    configurations run): the loss within BF16_LOSS_RTOL, the state's
    dtypes the reference's, and the witness: the port's gradient norm no
    farther from the f32-compute norm of the same weights (the port's) than
    BF16_GNORM_SPREAD times the reference's."""
    jstate, jmetrics, state, metrics, _, jb = _one_step(arch, opt, "bfloat16")
    for k in jmetrics:
        if k != "grad_norm":
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                       rtol=BF16_LOSS_RTOL, err_msg=k)
    _same_layout(jstate, state)
    _, m32, _ = _port_step(arch, opt, "float32", jb)
    f32 = float(m32["grad_norm"])
    port, ref = float(metrics["grad_norm"]), float(jmetrics["grad_norm"])
    assert np.isfinite([port, ref, f32]).all()
    assert abs(port - f32) <= BF16_GNORM_SPREAD * abs(ref - f32), (port, ref, f32)


# the dense, SSM and encoder families here; the others in
# test_torch_lm_train_bf16_{moe_vlm,hybrid,v3}.py (each file's reference
# steps compile for 6-17 s apiece: split, each file stays under a minute)
HERE = [c for c in CASES if c.id in ("stablelm_3b", "mamba2_130m", "hubert_xlarge")]


@pytest.mark.parametrize("arch,opt", HERE)
def test_bf16_parameters_f32_compute_match_reference(arch, opt):
    check_f32_compute(arch, opt)


@pytest.mark.parametrize("arch,opt", HERE)
def test_bf16_compute_matches_reference(arch, opt):
    check_bf16_compute(arch, opt)


def test_bf16_crash_resume_bit_equal(tmp_path):
    """(c) tests/test_system.py's protocol on a bf16 train_loop (bf16
    parameters, gradients, moments and compute): the losses of steps 5-9
    after a crash at step 7 and a resume from the step-5 checkpoint equal
    the uninterrupted run's, and so does the final state, bit for bit.  The
    checkpoint's bf16 leaves are the reference's records: raw ``V2`` arrays
    with ``"dtype": "bfloat16"`` in the manifest, which the reference's
    restore reads as the port's own restore does, bit for bit."""
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16", opt_dtype="bfloat16")
    cfg = reduced(get_config("stablelm_3b")).with_overrides(**over)
    hp = train.TrainHParams(total_steps=10, warmup_steps=2, grad_accum=2, lr=1e-3)
    kw = dict(batch=4, seq=32, steps=10, log_every=100, device="cpu")
    state_ref, losses_ref, _ = train.train_loop(cfg, hp, ckpt_dir=None, **kw)
    with pytest.raises(RuntimeError, match="injected"):
        train.train_loop(cfg, hp, ckpt_dir=str(tmp_path), ckpt_every=5, fail_at_step=7, **kw)
    state_res, losses_res, _ = train.train_loop(cfg, hp, ckpt_dir=str(tmp_path),
                                                ckpt_every=100, **kw)
    assert len(losses_res) == 5 and losses_res == losses_ref[5:]
    want, got = (dict(leaf_paths(stack_tree(s))) for s in (state_ref, state_res))
    assert want.keys() == got.keys() and int(got["step"]) == 10
    assert got["params/stages/layers/attn/wq"].dtype == torch.bfloat16
    assert got["opt/mu/stages/layers/attn/wq"].dtype == torch.bfloat16
    assert all(torch.equal(got[k], want[k]) for k in want)
    # the step-5 checkpoint as the reference reads it
    with open(tmp_path / "step_5" / "manifest.json") as f:
        manifest = {leaf["name"]: leaf for leaf in json.load(f)["leaves"]}
    ours, _ = ckpt.restore(str(tmp_path), 5, state_res)
    ours = dict(leaf_paths(stack_tree(ours)))
    jhp = dataclasses.replace(jtrain.TrainHParams(), **dataclasses.asdict(hp))
    like = jtrain.abstract_train_state(JModel(jreduced(jget_config("stablelm_3b"))
                                              .with_overrides(**over)), jhp)
    theirs, _ = jckpt.restore(str(tmp_path), 5, like)
    theirs = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert len(theirs) == len(ours)
    n_bf16 = 0
    for path, w in theirs:
        name = "/".join(str(k.key) for k in path)
        if ours[name].dtype == torch.bfloat16:
            n_bf16 += 1
            assert manifest[name]["dtype"] == "bfloat16", name
            assert np.load(tmp_path / "step_5" / manifest[name]["file"]).dtype == np.dtype("V2")
        assert str(w.dtype) == str(ours[name].dtype).removeprefix("torch."), name
        assert np.array_equal(_np(ours[name]).reshape(-1).view(np.uint8),
                              np.asarray(w).reshape(-1).view(np.uint8)), name
    assert n_bf16 > 0
