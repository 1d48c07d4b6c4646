"""The LM multi-device path (repro_torch.distributed.{sharding, fsdp,
elastic, pipeline}, train_loop(mesh=), the MoE island, Server(mesh=))
against repro's own mesh runs.

One spawn of four gloo CPU ranks runs every port phase; the reference runs
at the same time in a subprocess on four forced host devices with ``Auto``
mesh axes (jax 0.9's ``make_mesh`` defaults to ``Explicit`` axes, on which
the reference's ``with_sharding_constraint`` raises).  Both sides start
from one reference-format checkpoint at step 0, written here from the
port's seeded init.  Checked:

* reduced stablelm trained 3 steps on (2, 2) and on (2, 1, 2): losses and
  parameters against the reference's same runs, within
  tests/test_torch_lm_train.py's tolerances;
* a crash in step 3 on (2, 2) resumed on (2, 2) from the step-2
  checkpoint: bit-equal to the uninterrupted run; the step-3 checkpoint restored on (4, 1) and on one
  device bit-equal to its files, and one more step from it on each;
* remat on and off bit-equal on the mesh, and one step's collectives
  (kind, count, bytes) equal to the dry run's derivation, for stablelm and
  for reduced deepseek-v2-lite (expert parallelism in the backward too),
  whose mesh step equals one device's; Adafactor and int8 compression on
  the mesh against one device;
* the expert-parallel island on (2, 2) at a capacity that drops: the same
  kept (token, expert) pairs as the reference's island, outputs within
  2e-5;
* Server(mesh=) on (1, 4) against one device, each rank holding the
  parameter bytes the reference's specs give it;
* pipeline_apply over a 4-stage ``pod`` axis against the reference's,
  within 1e-5.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.launch import multihost, train
from repro_torch.launch.serve import Server
from repro_torch.launch.specs import concrete_batch
from repro_torch.models.model import Model

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
HP = dict(total_steps=6, warmup_steps=2, grad_accum=2, lr=1e-3)
LOSS_RTOL, GNORM_RTOL, PARAM_RMS = 1e-5, 1e-3, 1e-2
B, S = 8, 32
EP_CAPACITY = 1.0      # drops pairs on reduced deepseek-v2-lite's 8 experts, top-2
PIPE = dict(n_stages=4, m=6, mb=3, d=16)


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b ** 2)), 1e-30))


def _hp(**over):
    return dataclasses.replace(train.TrainHParams(), **{**HP, **over})


def _ds_cfg(capacity=None):
    cfg = reduced(get_config("deepseek_v2_lite_16b"))
    return cfg if capacity is None else cfg.with_overrides(capacity_factor=capacity)


def _ep_inputs(root):
    """x (4, 16, d) and one MoE layer's weights (numpy), as both sides read them."""
    from repro_torch.models import moe
    cfg = _ds_cfg(EP_CAPACITY)
    rng = np.random.default_rng(11)
    w = {}
    for k, p in moe.moe_defs(cfg).items():
        if isinstance(p, dict):
            w.update({f"shared.{k2}": (p2.shape, p2) for k2, p2 in p.items()})
        else:
            w[k] = (p.shape, p)
    arrays = {k: (rng.standard_normal(shape) * (0.3 if k == "router" else
                                                shape[-2] ** -0.5)).astype(np.float32)
              for k, (shape, _) in w.items()}
    x = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    x += 2.0 * rng.standard_normal(cfg.d_model).astype(np.float32)   # skew: drops
    np.savez(os.path.join(root, "ep.npz"), x=x, **arrays)


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *parents, leaf = k.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


_REF_PROG = r"""
import dataclasses, json, math, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[2])
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.distributed.pipeline import pipeline_apply
from repro.distributed.sharding import logical_sharding, rules_for
from repro.launch.train import TrainHParams, train_loop
from repro.models import moe

root = sys.argv[1]
hp = dataclasses.replace(TrainHParams(), **json.loads(sys.argv[3]))
B, S, cap = json.loads(sys.argv[4])

def mesh(shape, names):
    return jax.make_mesh(shape, names, axis_types=(jax.sharding.AxisType.Auto,) * len(shape))

out = {}
cfg = reduced(get_config("stablelm_3b"))
for key, shape, names in (("m22", (2, 2), ("data", "model")),
                          ("m212", (2, 1, 2), ("pod", "data", "model"))):
    _, losses, _ = train_loop(cfg, hp, batch=B, seq=S, steps=3, mesh=mesh(shape, names),
                              ckpt_dir=os.path.join(root, "ref_" + key), ckpt_every=3,
                              log_every=100)
    out[key] = losses

pz = np.load(os.path.join(root, "pipe.npz"))
pipe = pipeline_apply(lambda p, x: jnp.tanh(x @ p[0] + p[1]),
                      (jnp.asarray(pz["w"]), jnp.asarray(pz["b"])), jnp.asarray(pz["x"]),
                      mesh((4,), ("pod",)), axis="pod")
np.save(os.path.join(root, "ref_pipe.npy"), np.asarray(pipe))

cfg = reduced(get_config("deepseek_v2_lite_16b")).with_overrides(capacity_factor=cap)
ez = dict(np.load(os.path.join(root, "ep.npz")))
x = jnp.asarray(ez.pop("x"))
params = {k: jnp.asarray(v) for k, v in ez.items() if not k.startswith("shared.")}
params["shared"] = {k[7:]: jnp.asarray(v) for k, v in ez.items() if k.startswith("shared.")}
m22 = mesh((2, 2), ("data", "model"))
with logical_sharding(m22, rules_for(cfg)):
    y = jax.jit(lambda x, p: moe.moe_ffn(x, p, cfg))(x, params)
np.save(os.path.join(root, "ref_ep.npy"), np.asarray(y))
# the island's kept (token, expert) pairs: data block d, model slice m
kept = []
b, s, d = x.shape
for db in range(2):
    xf = x[db * b // 2:(db + 1) * b // 2].reshape(-1, d)
    t = xf.shape[0]
    t_m = -(-t // 2)
    xf = jnp.pad(xf, ((0, 2 * t_m - t), (0, 0)))
    for m in range(2):
        xm = xf[m * t_m:(m + 1) * t_m]
        w, idx = moe._route(xm, params["router"], cfg)
        e_flat = np.asarray(idx).reshape(-1)
        order = np.argsort(e_flat, kind="stable")
        counts = np.bincount(e_flat, minlength=cfg.n_experts)
        starts = np.cumsum(counts) - counts
        pos = np.arange(len(e_flat)) - starts[e_flat[order]]
        c = int(math.ceil(t_m * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
        c = max(8, -(-c // 8) * 8)
        for o, p in zip(order, pos):
            tok = m * t_m + o // cfg.top_k
            if p < c and tok < t:
                kept.append([int(db * t + tok), int(e_flat[o])])
out["kept"] = sorted(kept)
json.dump(out, open(os.path.join(root, "ref.json"), "w"))
print("REF_OK")
"""


def _gathered(state, step):
    """Rank 0's whole tree of the state's params (numpy), None elsewhere."""
    whole = ckpt.gather_tree(state, step.shardings)
    if whole is None:
        return None
    return {n: t.float().numpy() for n, t in ckpt.leaf_paths(whole)}


def _one_step(cfg, hp, mesh, root, batch_seed=3):
    """One mesh step from the step-0 checkpoint (restored): metrics, the
    whole state on rank 0, the step's collectives."""
    from repro_torch.distributed import collectives, fsdp
    model = fsdp.shard_model(Model(cfg, device="meta"), mesh, device="cpu")
    state = train.make_mesh_train_state(model, hp, mesh)
    step = train.make_train_step(model, hp, mesh)
    if root is not None:
        restored, _ = ckpt.restore(root, 0, state, device="cpu", shardings=step.shardings)
        train.load_train_state(state, restored)
    batch = concrete_batch(cfg, B, S, train=True, seed=batch_seed, device="cpu")
    collectives.reset_counters()
    state, metrics = step(state, batch)
    counted = collectives.counters()
    return ({k: float(v) for k, v in metrics.items()}, _gathered(state, step), counted)


def _ranks(root):
    import torch.distributed as dist
    from repro_torch.distributed import collectives, elastic, fsdp
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import moe
    torch.set_num_threads(1)
    rank = dist.get_rank()
    out = {"rank": rank}
    m22 = make_mesh_for(model_parallel=2, device="cpu")
    m212 = make_mesh_for(model_parallel=2, pods=2, device="cpu")
    m41 = make_mesh_for(model_parallel=1, device="cpu")
    m14 = make_mesh_for(model_parallel=4, device="cpu")
    cfg = reduced(get_config("stablelm_3b"))
    kw = dict(batch=B, seq=S, log_every=100, device="cpu")

    # training from the reference's step-0 checkpoint, 3 steps
    for key, mesh in (("m22", m22), ("m212", m212)):
        _, out[key], _ = train.train_loop(cfg, _hp(), steps=3, mesh=mesh, ckpt_every=3,
                                          ckpt_dir=os.path.join(root, "port_" + key), **kw)
    # a crash after step 3 and a resume, against the uninterrupted run
    try:
        train.train_loop(cfg, _hp(), steps=5, mesh=m22, ckpt_every=1, fail_at_step=2,
                         ckpt_dir=os.path.join(root, "crash"), **kw)
    except RuntimeError as exc:
        out["crashed"] = str(exc)
    _, out["resumed"], _ = train.train_loop(cfg, _hp(), steps=5, mesh=m22, ckpt_every=5,
                                            ckpt_dir=os.path.join(root, "crash"), **kw)
    _, out["whole"], _ = train.train_loop(cfg, _hp(), steps=5, mesh=m22, ckpt_every=5,
                                          ckpt_dir=os.path.join(root, "whole"), **kw)
    # the step-3 checkpoint on (4, 1): each rank's blocks, and one more step
    model = Model(cfg, device="meta")
    abstract = train.abstract_train_state(model, _hp())
    tree, _ = elastic.elastic_restore(os.path.join(root, "port_m22"), 3, abstract,
                                      train.train_state_specs(model, _hp()), m41)
    out["blocks41"] = {n: t.numpy() for n, t in ckpt.leaf_paths(tree)}
    out["coord41"] = collectives._coord(m41)
    if rank == 0:
        shutil.copytree(os.path.join(root, "port_m22"), os.path.join(root, "elastic41"))
    dist.barrier()
    _, out["step4_41"], _ = train.train_loop(cfg, _hp(), steps=4, mesh=m41, ckpt_every=100,
                                             ckpt_dir=os.path.join(root, "elastic41"), **kw)

    # remat on and off, the step's collectives against the dry run
    step0 = os.path.join(root, "step0")
    for remat in ("none", "full"):
        c = cfg.with_overrides(remat=remat)
        out[f"remat_{remat}"] = _one_step(c, _hp(), m22, step0)
    out["derived"] = dryrun.train_collectives(cfg.with_overrides(remat="full"), _hp(),
                                              m22, B, S)
    ds = _ds_cfg().with_overrides(remat="full")
    out["ds"] = _one_step(ds, _hp(), m22, None)
    out["ds_derived"] = dryrun.train_collectives(ds, _hp(), m22, B, S)
    out["adafactor"] = _one_step(cfg, _hp(optimizer="adafactor"), m22, None)
    out["compressed"] = _one_step(cfg, _hp(grad_compression=True), m22, None)

    # the expert-parallel island at a dropping capacity on (2, 2)
    ez = dict(np.load(os.path.join(root, "ep.npz")))
    x = torch.from_numpy(ez.pop("x"))
    params = _nest({k: torch.from_numpy(v) for k, v in ez.items()})
    ecfg = _ds_cfg(EP_CAPACITY)
    d_i = collectives.axis_index(m22, ("data",))
    m_i = collectives.axis_index(m22, ("model",))
    xl = x[d_i * 2:(d_i + 1) * 2]
    moe.DROPS = []
    with sh.logical_sharding(m22, sh.rules_for(ecfg)):
        out["ep_y"] = moe.moe_ffn(xl, params, ecfg).numpy()
    out["ep_drops"] = sum(moe.DROPS)
    moe.DROPS = None
    xf = xl.reshape(-1, ecfg.d_model)
    t = xf.shape[0]
    t_m = -(-t // 2)
    xm = torch.nn.functional.pad(xf, (0, 0, 0, 2 * t_m - t))[m_i * t_m:(m_i + 1) * t_m]
    _, idx = moe._route(xm, params["router"], ecfg)
    _, order, _, keep = moe.dispatch_plan(idx, ecfg)
    e_sorted = idx.reshape(-1)[order]
    out["ep_kept"] = sorted([d_i * t + m_i * t_m + int(o) // ecfg.top_k, int(e)]
                            for o, e, k in zip(order, e_sorted, keep)
                            if k and m_i * t_m + int(o) // ecfg.top_k < t)
    out["ep_pairs"] = int(keep.numel())

    # Server(mesh=) on (1, 4)
    server = Server(_ds_cfg(), mesh=m14, device="cpu")
    batch = concrete_batch(_ds_cfg(), 4, 12, train=False, seed=5, device="cpu")
    out["serve_tokens"] = server.generate(batch, 6, seq_cap=18).numpy()
    local, _ = server.local(batch)
    with server.context(local["tokens"].shape[0]), torch.no_grad():
        logits = server.compute.prefill(local, 18)[0]
    # this rank's vocab columns, gathered whole
    out["serve_logits"] = torch.cat(collectives.all_gather_axes(logits, m14, ("model",)),
                                    dim=-1).numpy()
    out["serve_resident"] = fsdp.resident_bytes(server.model.param_tree())
    out["serve_derived"] = dryrun.cell_bytes(_ds_cfg(), ShapeSpec("s", "decode", 18, 4),
                                             m14)["params_bytes"]

    # the pipeline over a 4-stage pod axis
    pz = np.load(os.path.join(root, "pipe.npz"))
    mpod = make_mesh_for(model_parallel=1, pods=4, device="cpu")
    timings = {}
    out["pipe"] = pipeline_apply(
        lambda p, xb: torch.tanh(xb @ p[0] + p[1]),
        (torch.from_numpy(pz["w"]), torch.from_numpy(pz["b"])), torch.from_numpy(pz["x"]),
        mpod, axis="pod", timings=timings).numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm_mesh")
    # the step-0 checkpoint, in the reference's format, for both sides: the
    # port's seeded init (the reference restores it instead of its own init)
    state0 = train.make_train_state(Model(reduced(get_config("stablelm_3b")), device="cpu",
                                          seed=0), _hp())
    ckpt.save(str(root / "step0"), 0, state0, extra={"data_step": 0})
    for d in ("ref_m22", "ref_m212", "port_m22", "port_m212", "crash", "whole"):
        shutil.copytree(root / "step0", root / d)
    rng = np.random.default_rng(2)
    p = PIPE
    np.savez(root / "pipe.npz",
             w=(rng.standard_normal((p["n_stages"], p["d"], p["d"])) * (0.5 / np.sqrt(p["d"]))
                ).astype(np.float32),
             b=(rng.standard_normal((p["n_stages"], p["d"])) * 0.1).astype(np.float32),
             x=rng.standard_normal((p["m"], p["mb"], p["d"])).astype(np.float32))
    _ep_inputs(str(root))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_PROG, str(root), str(ROOT / "src"), json.dumps(HP),
         json.dumps([B, S, EP_CAPACITY])], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = multihost.spawn(_ranks, 4, str(root), device="cpu",
                               init_file=str(root / "rendezvous"), timeout=300)
    finally:
        stdout, stderr = ref.communicate(timeout=300)
    assert ref.returncode == 0 and "REF_OK" in stdout, stderr[-3000:]
    with open(root / "ref.json") as f:
        refout = json.load(f)
    return port, refout, root


def _files(directory, step):
    """The checkpoint's leaves as numpy (bf16 as f32), by name."""
    with open(os.path.join(directory, f"step_{step}", "manifest.json")) as f:
        man = json.load(f)
    return {e["name"]: ckpt._load_npy(os.path.join(directory, f"step_{step}", e["file"]),
                                      e["dtype"]).float().numpy() for e in man["leaves"]}


@pytest.mark.parametrize("mesh", ["m22", "m212"])
def test_training_matches_reference_mesh_run(runs, mesh):
    port, ref, root = runs
    np.testing.assert_allclose(port[0][mesh], ref[mesh], rtol=LOSS_RTOL)
    assert all(p[mesh] == port[0][mesh] for p in port)
    got, want = _files(root / f"port_{mesh}", 3), _files(root / f"ref_{mesh}", 3)
    assert got.keys() == want.keys()
    for name in want:
        if name.startswith("params/"):
            assert rel_rms(got[name], want[name]) < PARAM_RMS, name
    assert got["step"] == want["step"] == 3


def test_resume_on_the_same_mesh_is_bit_equal(runs):
    port, _, root = runs
    assert "injected failure at step 2" in port[0]["crashed"]
    assert port[0]["resumed"] == port[0]["whole"][2:]
    got, want = _files(root / "crash", 5), _files(root / "whole", 5)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_elastic_restore_on_41_and_one_device_bit_equal(runs):
    from repro_torch.distributed import sharding as sh
    port, _, root = runs
    files = _files(root / "port_m22", 3)
    cfg = reduced(get_config("stablelm_3b"))
    model = Model(cfg, device="meta")
    shard = sh.tree_shardings(train.abstract_train_state(model, _hp()),
                              train.train_state_specs(model, _hp()),
                              sh.AbstractMesh(("data", "model"), (4, 1)))
    by_name = dict(ckpt.leaf_paths(shard))
    coords = sh.mesh_coords(sh.AbstractMesh(("data", "model"), (4, 1)))
    order = [next(p for p in port if p["coord41"] == c) for c in coords]
    for name, want in files.items():
        blocks = [torch.from_numpy(p["blocks41"][name]).float() for p in order]
        whole = sh.from_shards(blocks, by_name[name].spec, by_name[name].mesh)
        assert np.array_equal(whole.numpy(), want), name
    # one device: the whole restore, and one more step from it on each side
    m = Model(cfg, device="cpu")
    state = train.make_train_state(m, _hp())
    restored, man = ckpt.restore(str(root / "port_m22"), 3, state, device="cpu")
    for name, t in ckpt.leaf_paths(train.load_train_state(state, restored)):
        t = torch.stack(t) if isinstance(t, list) else t
        assert np.array_equal(t.detach().float().numpy(), files[name]), name
    shutil.copytree(root / "port_m22", root / "one_device")
    _, losses, _ = train.train_loop(cfg, _hp(), batch=B, seq=S, steps=4, log_every=100,
                                    ckpt_dir=str(root / "one_device"), device="cpu")
    np.testing.assert_allclose(port[0]["step4_41"], losses, rtol=LOSS_RTOL)


def test_remat_bit_equal_and_collectives_equal_dry_run(runs):
    port, _, _ = runs
    off, on = port[0]["remat_none"], port[0]["remat_full"]
    assert off[0] == on[0]
    assert all(np.array_equal(on[1][k], off[1][k]) for k in off[1])
    for key, derived in (("remat_full", "derived"), ("ds", "ds_derived")):
        for p in port:
            counted = p[key][2]
            for kind in ("all-gather", "reduce-scatter", "all-to-all", "collective-permute"):
                assert counted[kind] == p[derived][kind], (key, kind, p["rank"])
    assert port[0]["ds"][2]["all-to-all"]["count"] > 0


def _one_device_step(cfg, hp, root):
    model = Model(cfg, device="cpu")
    state = train.make_train_state(model, hp)
    if root is not None:
        restored, _ = ckpt.restore(str(root), 0, state, device="cpu")
        train.load_train_state(state, restored)
    batch = concrete_batch(cfg, B, S, train=True, seed=3, device="cpu")
    state, metrics = train.make_train_step(model, hp)(state, batch)
    from repro_torch.models.convert import stack_tree
    return ({k: float(v) for k, v in metrics.items()},
            {n: t.detach().float().numpy() for n, t in ckpt.leaf_paths(stack_tree(state))})


@pytest.mark.parametrize("key", ["remat_full", "ds", "adafactor", "compressed"])
def test_mesh_step_matches_one_device(runs, key):
    port, _, root = runs
    cfg = reduced(get_config("stablelm_3b"))
    hp = {"remat_full": _hp(), "ds": _hp(), "adafactor": _hp(optimizer="adafactor"),
          "compressed": _hp(grad_compression=True)}[key]
    if key == "ds":
        cfg, step0 = _ds_cfg().with_overrides(remat="full"), None
    elif key == "remat_full":
        cfg, step0 = cfg.with_overrides(remat="full"), root / "step0"
    else:
        step0 = None
    metrics, whole = _one_device_step(cfg, hp, step0)
    mine, mwhole, _ = port[0][key]
    np.testing.assert_allclose(mine["loss"], metrics["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(mine["grad_norm"], metrics["grad_norm"], rtol=GNORM_RTOL)
    assert mwhole.keys() == whole.keys()
    for name in whole:
        if name.startswith("params/"):
            assert rel_rms(mwhole[name], whole[name]) < PARAM_RMS, name


def test_expert_parallel_island_matches_reference(runs):
    port, ref, root = runs
    want = np.load(root / "ref_ep.npy")
    for p in port:
        d = p["rank"] // 2
        np.testing.assert_allclose(p["ep_y"], want[d * 2:(d + 1) * 2], rtol=0, atol=2e-5)
    kept = sorted(pair for p in port for pair in p["ep_kept"])
    assert kept == ref["kept"]
    dropped = sum(p["ep_drops"] for p in port)
    assert dropped == sum(p["ep_pairs"] for p in port) - len(kept) > 0


def test_server_on_a_mesh_matches_one_device(runs):
    port, _, _ = runs
    cfg = _ds_cfg()
    server = Server(cfg, device="cpu")
    batch = concrete_batch(cfg, 4, 12, train=False, seed=5, device="cpu")
    want = server.generate(batch, 6, seq_cap=18).numpy()
    logits = server.compute.prefill(batch, 18)[0].numpy()
    for p in port:
        assert np.array_equal(p["serve_tokens"], want)
        np.testing.assert_allclose(p["serve_logits"], logits, rtol=0, atol=1e-5)
    # every rank keeps its blocks: the bytes the reference's specs give it,
    # under a quarter of the whole model's
    full = sum(t.numel() * t.element_size() for t in server.model.parameters())
    for p in port:
        assert p["serve_resident"] == p["serve_derived"] < full // 3


def test_pipeline_matches_reference(runs):
    port, _, root = runs
    want = np.load(root / "ref_pipe.npy")
    for p in port:
        np.testing.assert_allclose(p["pipe"], want, rtol=0, atol=1e-5)
    pz = np.load(root / "pipe.npz")
    seq = pz["x"]
    for s in range(PIPE["n_stages"]):
        seq = np.tanh(seq @ pz["w"][s] + pz["b"][s])
    np.testing.assert_allclose(port[0]["pipe"], seq, rtol=0, atol=1e-5)
