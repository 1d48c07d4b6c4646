"""The port's train step and loop (repro_torch.launch.train) against repro's,
and the port's own invariants: one make_train_step with grad_accum=2
against the reference's (loss, grad_norm, parameters by relative RMS),
remat on and off bit-equal, grad_accum=2 against one whole batch, the
crash-and-resume trajectory bit-equal (tests/test_system.py's protocol),
fixed-batch memorisation (its protocol and threshold), the microbatch
split, the CLI on the CPU, train_loop(mesh=) on a one-rank mesh, and the
entry points' refusals without a card."""

import dataclasses
import os
import pickle
import signal
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch import train as jtrain
from repro.launch.specs import concrete_batch as jconcrete_batch
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, reduced
from repro_torch.distributed.checkpoint import leaf_paths
from repro_torch.launch import train
from repro_torch.launch.specs import concrete_batch
from repro_torch.models.convert import params_from_reference, stack_tree
from repro_torch.models.model import Model
from test_torch_lm_model import port_weights
from test_torch_lm_train_bf16 import GRAD_GATED, GRAD_REL, grads_tree, reference_grads

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


def _hp(steps, **over):
    """tests/test_system.py's hyperparameters."""
    kw = dict(total_steps=steps, warmup_steps=2, grad_accum=2, lr=1e-3)
    return dataclasses.replace(train.TrainHParams(), **{**kw, **over})


def reference_train_state(jcfg, jhp, weights) -> dict:
    """The reference's own ``make_train_state`` around ``weights`` (a
    parameter tree of numpy arrays) in place of its init."""
    model = types.SimpleNamespace(cfg=jcfg, init=lambda key: jax.tree.map(jnp.asarray, weights))
    return jtrain.make_train_state(model, jhp, jax.random.key(0))


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b ** 2)), 1e-30))


# one step against the reference: the loss within f32 rounding; the
# gradient norm within GNORM_RTOL (the per-leaf gradients agree within
# 2e-3 of each leaf's largest |g|, tests/test_torch_lm_grads.py); the
# parameters by relative RMS within PARAM_RMS: Adam's normalised update
# turns a gradient difference of 1e-4 into a sign flip wherever the
# gradient is near 0, moving that element by up to 2 lr (lr 1e-3 here);
# the leaves of GRAD_GATED, whose gradient is rounding noise, are held by
# their gradient instead (test_torch_lm_train_bf16.py; qwen2-vl's key bias
# lay 9.2e-3 from the reference's in f32)
LOSS_RTOL, GNORM_RTOL, PARAM_RMS = 1e-5, 1e-3, 1e-2


# (arch, config overrides, hyperparameters): "recipe" takes the reference's
# own default_hparams_for (deepseek-v3: Adafactor, grad_accum 4, no weight
# decay) at the peak rate; "dense" cuts deepseek-v3 to its dense layers, so
# its moe_layers stage has no layer and every leaf of it the shape (0, ...)
STEP_CASES = [
    pytest.param("stablelm_3b", {"opt_dtype": "float32"}, {}, id="float32"),
    pytest.param("stablelm_3b", {"opt_dtype": "bfloat16"}, {}, id="bfloat16"),
    pytest.param("deepseek_v2_lite_16b", {}, {}, id="deepseek_v2_lite_16b-adamw"),
    pytest.param("zamba2_7b", {}, {}, id="zamba2_7b-adamw"),
    pytest.param("hubert_xlarge", {}, {}, id="hubert_xlarge-adamw"),
    pytest.param("qwen2_vl_7b", {}, {}, id="qwen2_vl_7b-adamw"),    # the VLM, f32
    pytest.param("deepseek_v3_671b", {}, "recipe", id="deepseek_v3_671b-recipe"),
    pytest.param("deepseek_v3_671b", "dense", {"optimizer": "adafactor"},
                 id="deepseek_v3_671b-dense-adafactor"),
    pytest.param("deepseek_v3_671b", "dense", {}, id="deepseek_v3_671b-dense-adamw"),
]


# the cases run here; the moe, hybrid and deepseek-v3 ones in
# test_torch_lm_train_step.py (each file's reference compiles stay under a
# minute or so)
HERE = ("float32", "bfloat16", "hubert_xlarge-adamw", "qwen2_vl_7b-adamw")


@pytest.mark.parametrize("arch,cfg_over,hp_over", [c for c in STEP_CASES if c.id in HERE])
def test_train_step_matches_reference(arch, cfg_over, hp_over):
    check_train_step(arch, cfg_over, hp_over)


def check_train_step(arch, cfg_over, hp_over):
    """One step at the peak rate (warmup 0) against the reference's: stablelm-3b
    with grad_accum=2 and AdamW with f32 moments, and with bf16 moments
    (deepseek-v3's opt_dtype); the moe (MLA, routed and shared experts),
    hybrid (the shared block's summed gradient) and encoder (frames, the
    same-position loss) families with AdamW; deepseek-v3's own recipe
    (Adafactor, 4 microbatches, the MTP loss); and deepseek-v3 cut to its
    dense layers under either optimizer, whose empty MoE stage must keep the
    reference's (0, ...) leaves through the step; the VLM (the vision
    splice, M-RoPE positions split into microbatches), its key bias held by
    its gradient before the clip (GRAD_GATED)."""
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    if cfg_over == "dense":
        cfg_over = {"n_layers": cfg.first_dense_layers}
    jcfg, cfg = jcfg.with_overrides(**cfg_over), cfg.with_overrides(**cfg_over)
    over = dict(optimizer="adamw", warmup_steps=0, total_steps=10, grad_accum=2, lr=1e-3)
    if hp_over == "recipe":
        recipe = train.default_hparams_for(cfg)
        hp_over = dict(optimizer=recipe.optimizer, grad_accum=recipe.grad_accum,
                       weight_decay=recipe.weight_decay)
        jrecipe = jtrain.default_hparams_for(jcfg)
        assert hp_over == {k: getattr(jrecipe, k) for k in hp_over}
        assert hp_over["optimizer"] == "adafactor" and hp_over["grad_accum"] == 4
    over.update(hp_over)
    jhp = dataclasses.replace(jtrain.TrainHParams(), **over)
    jm = JModel(jcfg)
    weights = port_weights(arch, **cfg_over)
    jstate = reference_train_state(jcfg, jhp, weights)
    params = jstate["params"]
    model = params_from_reference(weights, Model(cfg, device="cpu"))
    state = train.make_train_state(model, train.TrainHParams(**over))
    jb = jconcrete_batch(jcfg, 4, 16, train=True, seed=3)
    gated = GRAD_GATED.get(arch, ())
    jstate, jmetrics = jax.jit(jtrain.make_train_step(jm, jhp))(jstate, jb)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    state, metrics = train.make_train_step(model, train.TrainHParams(**over))(state, tb)
    assert {"loss", "grad_norm"} <= set(metrics)
    assert ("mtp" in metrics) == bool(cfg.mtp_depth)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=GNORM_RTOL if k == "grad_norm" else LOSS_RTOL,
                                   err_msg=k)
    assert int(state["step"]) == int(jstate["step"]) == 1
    got = dict(leaf_paths(stack_tree(state)))
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jstate))[0]
    assert sorted(got) == sorted("/".join(str(k.key) for k in p) for p, _ in flat)
    for path, want in flat:
        name = "/".join(str(k.key) for k in path)
        assert tuple(got[name].shape) == want.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(want.dtype), name
        if name.startswith("params/") and want.size and name not in gated:
            assert rel_rms(got[name].float().numpy(), want.astype(np.float32)) < PARAM_RMS, name
    if gated:       # the same step's gradients before the clip, of each package
        again = params_from_reference(weights, Model(cfg, device="cpu"))
        hp = train.TrainHParams(**over)
        train.make_train_step(again, hp).grads(train.make_train_state(again, hp), tb)
        port = dict(leaf_paths(grads_tree(again.param_tree())))
        ref = dict(leaf_paths(jax.jit(lambda p: reference_grads(jm, jhp, p, jb))(params)))
        for name in gated:
            g, w = port[name.removeprefix("params/")].numpy(), np.asarray(ref[name.removeprefix(
                "params/")])
            assert float(np.abs(w).max()) > 0, name
            np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * float(np.abs(w).max()),
                                       err_msg=name)


def _loss_and_grads(model, batch):
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(batch)
    loss.backward()
    return loss.detach(), [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("arch", ["stablelm_3b", "zamba2_7b", "deepseek_v3_671b"])
def test_remat_on_and_off_bit_equal(arch):
    """remat="full" (every plan entry and cross-entropy chunk recomputed in
    backward) against remat="none": the same loss and gradients, bit for
    bit (the hybrid's shared block at each invocation; v3's MTP head)."""
    cfg = reduced(get_config(arch))
    on = Model(cfg.with_overrides(remat="full"), device="cpu", seed=1)
    off = Model(cfg, device="cpu", seed=1)
    assert off.cfg.remat == "none"
    batch = concrete_batch(cfg, 2, 16, train=True, seed=2, device="cpu")
    loss_on, g_on = _loss_and_grads(on, batch)
    loss_off, g_off = _loss_and_grads(off, batch)
    assert torch.equal(loss_on, loss_off)
    assert len(g_on) == len(g_off) and all(torch.equal(a, b) for a, b in zip(g_on, g_off))


def test_remat_recomputes_in_backward():
    """Under remat each plan entry runs twice (forward and backward's
    recompute), without it once; under no_grad remat is off."""
    cfg = reduced(get_config("stablelm_3b")).with_overrides(remat="full")
    model = Model(cfg, device="cpu")
    calls = []
    for block in model.plan:
        block.register_forward_pre_hook(lambda m, args: calls.append(m))
    batch = concrete_batch(cfg, 2, 8, train=True, device="cpu")
    loss, _ = model.loss(batch)
    assert len(calls) == cfg.n_layers
    loss.backward()
    assert len(calls) == 2 * cfg.n_layers
    with torch.no_grad():
        model.loss(batch)
    assert len(calls) == 3 * cfg.n_layers


def test_grad_accum_matches_whole_batch():
    """grad_accum=2 (two backward passes summed into .grad, times 1/2)
    against one pass over the whole batch: the mean loss and the gradients
    within f32 rounding of a sum split in two."""
    cfg = reduced(get_config("qwen2_vl_7b"))       # positions split on axis 1
    batch = concrete_batch(cfg, 4, 16, train=True, seed=4, device="cpu")
    out = {}
    for accum in (1, 2):
        model = Model(cfg, device="cpu", seed=0)
        hp = _hp(10, grad_accum=accum)
        step = train.make_train_step(model, hp)
        state = train.make_train_state(model, hp)
        metrics = step.grads(state, batch)
        out[accum] = (metrics, [p.grad.clone() for p in model.parameters()])
    (m1, g1), (m2, g2) = out[1], out[2]
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    for a, b in zip(g2, g1):
        scale = max(float(b.abs().max()), 1e-12)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5 * scale)


def test_split_microbatches_contiguous_rows_and_positions():
    batch = {"tokens": torch.arange(8).reshape(4, 2),
             "positions": torch.arange(24).reshape(3, 4, 2)}
    mbs = train._split_microbatches(batch, 2)
    assert torch.equal(mbs[1]["tokens"], batch["tokens"][2:])
    assert torch.equal(mbs[0]["positions"], batch["positions"][:, :2])
    with pytest.raises(ValueError, match="not a multiple"):
        train._split_microbatches(batch, 3)


def _final_state(state):
    return {name: t.clone() for name, t in leaf_paths(stack_tree(state))}


# (arch, config overrides, hyperparameters): step 25's AdamW on stablelm-3b,
# and the encoder under Adafactor with int8 error-feedback compression at
# d_model 128, where Adafactor factors the second moments of the MLP, the
# token table and the head
RESUME_CASES = [
    pytest.param("stablelm_3b", {}, {}, id="adamw"),
    pytest.param("hubert_xlarge", {"d_model": 128},
                 {"optimizer": "adafactor", "grad_compression": True},
                 id="hubert_xlarge-adafactor-compression"),
]


@pytest.mark.parametrize("arch,cfg_over,hp_over", RESUME_CASES)
def test_crash_resume_trajectory_bit_equal(tmp_path, arch, cfg_over, hp_over):
    """tests/test_system.py's protocol, bit for bit: the losses of steps
    5-9 replayed after a crash at step 7 and a resume from the step-5
    checkpoint equal the uninterrupted run's, and so do the final
    parameters, optimizer state (Adafactor's factored statistics), the
    compression residuals and step."""
    cfg = reduced(get_config(arch)).with_overrides(**cfg_over)
    kw = dict(batch=4, seq=32, steps=10, log_every=100, device="cpu")
    hp = _hp(10, **hp_over)
    state_ref, losses_ref, _ = train.train_loop(cfg, hp, ckpt_dir=None, **kw)
    with pytest.raises(RuntimeError, match="injected"):
        train.train_loop(cfg, hp, ckpt_dir=str(tmp_path), ckpt_every=5,
                         fail_at_step=7, **kw)
    state_res, losses_res, wd = train.train_loop(cfg, hp, ckpt_dir=str(tmp_path),
                                                 ckpt_every=100, **kw)
    assert len(losses_res) == 5 and losses_res == losses_ref[5:]
    assert len(wd.durations) == 5
    want, got = _final_state(state_ref), _final_state(state_res)
    must = ({"opt/stages/layers/ffn/wg/vr", "opt/head/out/vc", "ef_err/head/out"}
            if hp.optimizer == "adafactor" else {"opt/nu/stages/layers/attn/wq"})
    assert want.keys() == got.keys() and must <= set(got)
    assert all(torch.equal(got[k], want[k]) for k in want)
    if hp.grad_compression:
        assert bool(got["ef_err/head/out"].abs().max() > 0)
    assert int(got["step"]) == 10


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_empty_stage_on_a_one_rank_mesh(tmp_path, optimizer):
    """deepseek-v3 cut to its dense layers (a moe_layers stage of no layer)
    on a (1, 1) mesh of one gloo rank: the sharded state's (0, ...) leaves,
    their shardings, one step equal to one device's, and the checkpoint
    written from the mesh and read back on it and on one device."""
    import torch.distributed as dist
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import fsdp
    from repro_torch.launch.mesh import make_mesh_for
    cfg = reduced(get_config("deepseek_v3_671b"))
    cfg = cfg.with_overrides(n_layers=cfg.first_dense_layers)
    hp = _hp(10, optimizer=optimizer, warmup_steps=0)
    batch = concrete_batch(cfg, 2, 16, train=True, seed=1, device="cpu")
    one = Model(cfg, device="cpu")
    state_one, m_one = train.make_train_step(one, hp)(train.make_train_state(one, hp), batch)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0, world_size=1)
    try:
        mesh = make_mesh_for(device="cpu")
        model = fsdp.shard_model(Model(cfg, device="meta"), mesh, device="cpu")
        step = train.make_train_step(model, hp, mesh)
        state = train.make_mesh_train_state(model, hp, mesh)
        empty = state["params"]["stages"]["moe_layers"]["ffn"]["wg"]
        assert tuple(empty.shape) == (0, cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
        assert step.shardings["params"]["stages"]["moe_layers"]["ffn"]["wg"].shard_shape(
            empty.shape) == tuple(empty.shape)
        state, m = step(state, batch)
        ckpt.save(str(tmp_path / "ck"), 1, state, shardings=step.shardings)
        restored, _ = ckpt.restore(str(tmp_path / "ck"), 1, state, shardings=step.shardings)
        train.load_train_state(state, restored)
    finally:
        dist.destroy_process_group()
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in m_one.items()}
    want, got = _final_state(state_one), _final_state(state)
    assert want.keys() == got.keys() and got["params/stages/moe_layers/ffn/router"].numel() == 0
    assert all(torch.equal(got[k], want[k]) for k in want)
    back, _ = ckpt.restore(str(tmp_path / "ck"), 1, state_one)
    assert {k: t.shape for k, t in leaf_paths(stack_tree(back))} == {
        k: t.shape for k, t in want.items()}


def test_loss_decreases_over_training():
    """tests/test_system.py's memorisation protocol and threshold: repeated
    steps on one fixed batch."""
    cfg = reduced(get_config("minitron_4b"))
    model = Model(cfg, device="cpu")
    hp = _hp(30)
    state = train.make_train_state(model, hp)
    step = train.make_train_step(model, hp)
    batch = concrete_batch(cfg, 4, 32, train=True, device="cpu")
    losses = []
    for _ in range(15):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])
    assert all(np.isfinite(x) for x in losses)


def test_grad_compression_keeps_the_residuals():
    """int8 error feedback on the gradients: the residual tree in the
    reference's layout, non-zero after a step, the loss finite."""
    cfg = reduced(get_config("mamba2_130m"))
    model = Model(cfg, device="cpu")
    hp = _hp(10, grad_compression=True)
    state = train.make_train_state(model, hp)
    state, m = train.make_train_step(model, hp)(state, concrete_batch(
        cfg, 4, 16, train=True, device="cpu"))
    err = state["ef_err"]["stages"]["layers"]["mixer"]["wx"]
    assert err.shape == (cfg.n_layers, cfg.d_model, cfg.ssm_d_inner) and bool(err.abs().max() > 0)
    assert np.isfinite(float(m["loss"]))


def test_cli_runs_on_the_cpu(capsys):
    train.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "done: 2 steps" in out and "on cpu" in out


ROOT = Path(__file__).resolve().parent.parent
# the child that runs a launcher's main: its result comes back pickled
_MAIN_PROG = """
import importlib, pickle, sys
result = importlib.import_module(sys.argv[1]).main(sys.argv[3:])
with open(sys.argv[2], "wb") as f:
    pickle.dump(result, f)
"""


def bounded_main(module: str, argv: list, tmp_path, timeout: float = 300.0):
    """``module.main(argv)`` in a child Python process that leads a
    process group of its own, and its return value.  The launcher's
    ``--mesh`` ranks wait for each other without a limit
    (``multihost.spawn_launcher``): if the child has not returned within
    ``timeout`` s, it and every rank it started are killed and the test
    fails."""
    out = tmp_path / "main_result.pkl"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]] if "PYTHONPATH" in os.environ else [])))
    proc = subprocess.Popen([sys.executable, "-c", _MAIN_PROG, module, str(out), *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=ROOT, start_new_session=True)
    try:
        _, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate(timeout=60)
        raise
    assert proc.returncode == 0, stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def test_cli_trains_on_a_mesh_of_two_ranks(capsys, tmp_path):
    """``--mesh --ranks 2`` starts two gloo ranks on the launcher's mesh,
    (data, model) = (1, 2); the losses are one device's up to association
    order.  The mesh run is a child process with a time limit
    (bounded_main)."""
    argv = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16"]
    want = train.main(argv)
    got = bounded_main("repro_torch.launch.train", argv + ["--mesh", "--ranks", "2"], tmp_path)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_entry_points_refuse(tmp_path):
    """train_loop(mesh=) runs (a (1, 1) mesh of one gloo rank in this
    process: the mesh path, its losses those of one device); without a
    GPU the card's entry points raise."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_for
    cfg = reduced(get_config("stablelm_3b"))
    _, want, _ = train.train_loop(cfg, _hp(2), batch=2, seq=8, steps=2, device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0, world_size=1)
    try:
        mesh = make_mesh_for(device="cpu")
        state, got, _ = train.train_loop(cfg, _hp(2), batch=2, seq=8, steps=2, mesh=mesh,
                                         device="cpu")
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert int(state["step"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--reduced", "--steps", "1"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.train_loop(cfg, _hp(2), batch=2, seq=8, steps=1)


def test_serving_records_no_graph():
    """Trainable parameters, and prefill / decode record no graph."""
    cfg = reduced(get_config("stablelm_3b"))
    model = Model(cfg, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    batch = concrete_batch(cfg, 2, 8, train=False, device="cpu")
    logits, cache = model.prefill(batch, 12)
    assert logits.grad_fn is None and not logits.requires_grad
    assert all(not t.requires_grad for c in cache for t in c.values())
    logits, _ = model.decode_step(cache, torch.ones((2, 1), dtype=torch.int32), 8)
    assert not logits.requires_grad
