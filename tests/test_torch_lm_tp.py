"""Tensor parallelism and the sequence-split decode cache on the LM mesh
(the reference's activation sharding: heads, MLP width, vocab and SSM heads
over ``model``, flash-decoding over a ``cache_seq``-split cache) against
the reference's own mesh runs.

One spawn of four gloo CPU ranks runs the port's serving; the reference
runs at the same time in a subprocess on four forced host devices with ``Auto``
mesh axes, as tests/test_torch_lm_mesh.py does.  Both sides start from one
reference-format checkpoint at step 0 per configuration, which the test
writes from the port's seeded init before either side starts (the
reference restores it instead of running its own init).  Five reduced configurations, each a case of the split:
stablelm (KV heads split), chatglm3 with 8 q heads on 2 KV heads (the q
group split on (1, 4)), qwen2.5 (q/k/v bias; on (1, 4) its 4 heads on 2 KV
heads split neither way, the reference's q-sequence case: each rank
computes its query rows, tests/test_torch_lm_cp.py), deepseek-v2-lite (MLA, shared experts, the
expert-parallel island) and zamba2 (SSM heads, the shared attention
block).  Checked, per configuration:

* ``Server(mesh=)`` on (1, 4) and (2, 2): the greedy tokens equal the
  reference's, the prefill's and every decode step's logits within LOGIT_TOL
  of the largest |logit|, every rank the same tokens;
* one prefill's and decode step's collectives (kind, count, bytes) equal
  to the dry run's derivation, and each rank's resident parameter and
  cache bytes equal to ``cell_bytes``' argument bytes;
* ``init_shards`` equal to one device's ``Model(cfg, seed)`` bit for bit.

Training (three steps on (2, 2) against the reference's run, one train
step's collectives) is test_torch_lm_tp_train.py's, with its own ranks and
reference process: each file's fixture stays near a minute.

And without ranks: a wrong layout at a ``constrain`` site raises, the
attention cases follow ``_score_axes``, and no tensor-parallel leaf is
gathered over ``model`` on the production meshes.
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

from repro_torch.configs import ALIASES, get_config, reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, multihost, train

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# name -> (arch, overrides of the reduced configuration, on both sides)
ARCHS = {
    "stablelm": ("stablelm_3b", {}),
    "chatglm3": ("chatglm3_6b", {"n_heads": 8}),
    "qwen": ("qwen2_5_32b", {}),
    "dsv2": ("deepseek_v2_lite_16b", {}),
    "zamba2": ("zamba2_7b", {}),
}
MESHES = {"m14": (1, 4), "m22": (2, 2)}
HP = dict(total_steps=6, warmup_steps=2, grad_accum=2, lr=1e-3)
LOSS_RTOL, PARAM_RMS, LOGIT_TOL = 1e-5, 1e-2, 1e-4
B, S = 8, 16                  # training batch
SB, PROMPT, NEW = 4, 8, 4     # serving: 4 prompts of 8 tokens, 4 new tokens
CAP = 12                      # the caches' length, split 4 and 2 ways


def _cfg(name):
    arch, over = ARCHS[name]
    return reduced(get_config(arch)).with_overrides(**over)


def _hp():
    return dataclasses.replace(train.TrainHParams(), **HP)


_REF_PROG = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[2])
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.distributed import checkpoint as ckpt
from repro.distributed.sharding import logical_sharding, rules_for
from repro.launch.train import TrainHParams, abstract_train_state, train_loop
from repro.models.model import Model

root = sys.argv[1]
hp = dataclasses.replace(TrainHParams(), **json.loads(sys.argv[3]))
archs, meshes, (B, S, new, cap) = json.loads(sys.argv[4]), json.loads(sys.argv[5]), \
    json.loads(sys.argv[6])
phase = sys.argv[7]     # "train" or "serve"

def mesh(shape):
    return jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

tokens = jnp.asarray(np.load(os.path.join(root, "prompts.npy")))
# the step-0 weights, from the checkpoint both sides start from
params = {}
for name, (arch, over) in archs.items() if phase == "serve" else ():
    cfg = reduced(get_config(arch)).with_overrides(**over)
    like = abstract_train_state(Model(cfg), hp)
    params[name] = ckpt.restore(os.path.join(root, "step0_" + name), 0, like)[0]["params"]
out = {}
for name, (arch, over) in archs.items():
    cfg = reduced(get_config(arch)).with_overrides(**over)
    out[name] = {}
    if phase == "train":
        _, out[name]["losses"], _ = train_loop(
            cfg, hp, batch=B, seq=S, steps=3, mesh=mesh((2, 2)),
            ckpt_dir=os.path.join(root, "ref_" + name), ckpt_every=3, log_every=100)
        continue
    model = Model(cfg)
    prefill = jax.jit(lambda p, b: model.prefill(p, b, seq_cap=cap))
    decode = jax.jit(model.decode_step)
    for key, shape in meshes.items():
        with logical_sharding(mesh(shape), rules_for(cfg)):
            logits, cache = prefill(params[name], {"tokens": tokens})
            steps, toks = [np.asarray(logits)], []
            for i in range(new):
                tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
                toks.append(np.asarray(tok))
                logits, cache = decode(params[name], cache, tok,
                                       jnp.int32(tokens.shape[1] + i))
                steps.append(np.asarray(logits))
        np.save(os.path.join(root, f"ref_{name}_{key}_logits.npy"), np.stack(steps))
        out[name][key] = np.concatenate(toks, axis=1).tolist()
json.dump(out, open(os.path.join(root, f"ref_{phase}.json"), "w"))
print("REF_OK")
"""


def write_step0(root, cfgs, hp):
    """The step-0 checkpoint both sides start from, one per configuration:
    the port's seeded init (seed 0) with its optimizer state, in the
    reference's format under ``step0_<name>``, copied to ``ref_<name>`` and
    ``port_<name>``, where each side's training resumes from it."""
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.models.model import Model
    for name, cfg in cfgs.items():
        step0 = os.path.join(root, "step0_" + name)
        state = train.make_train_state(Model(cfg, device="cpu", seed=0), hp)
        ckpt.save(step0, 0, state, extra={"data_step": 0})
        for side in ("ref_", "port_"):
            shutil.copytree(step0, os.path.join(root, side + name))


def _counted(fn):
    from repro_torch.distributed import collectives
    collectives.reset_counters()
    result = fn()
    c = collectives.counters()
    return result, {k: c[k] for k in dryrun._empty()}


def _plus(a, b):
    return {k: {"count": a[k]["count"] + b[k]["count"], "bytes": a[k]["bytes"] + b[k]["bytes"]}
            for k in a}


def _derived(d):
    return {k: v for k, v in d.items() if k != "total_bytes"}


def _serve(name, cfg, mesh, key, root):
    """Generate from the step-0 checkpoint's weights on ``mesh``: the tokens,
    each step's logits (whole), the collectives of the prefill and of one
    decode step (each with its greedy pick), the resident bytes."""
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import collectives, fsdp
    from repro_torch.launch.serve import Server
    from repro_torch.models.model import Model
    model = fsdp.shard_model(Model(cfg, device="meta"), mesh, device="cpu")
    state = train.make_mesh_train_state(model, _hp(), mesh)
    restored, _ = ckpt.restore(os.path.join(root, "step0_" + name), 0, state, device="cpu",
                               shardings=train.train_shardings(model, _hp(), mesh))
    train.load_train_state(state, restored)
    del state, restored
    server = Server(cfg, model=model, mesh=mesh, device="cpu")
    tokens = torch.from_numpy(np.load(os.path.join(root, "prompts.npy")))
    out = {"tokens": server.generate({"tokens": tokens}, NEW, seq_cap=CAP).numpy()}
    local, axes = server.local({"tokens": tokens})
    rows = local["tokens"].shape[0]
    out["row0"] = collectives.axis_index(mesh, axes) * rows if axes else 0
    whole = lambda x: torch.cat(collectives.all_gather_axes(x, mesh, ("model",)), -1)
    logits, counted = [], {}
    with server.context(rows, SB), torch.no_grad():
        (lg, cache), c = _counted(lambda: server.compute.prefill(local, CAP))
        tok, c2 = _counted(lambda: server.argmax_over_vocab(lg))
        counted["prefill"] = _plus(c, c2)
        logits.append(whole(lg))
        for i in range(NEW):
            (lg, cache), c = _counted(lambda: server.compute.decode_step(
                cache, tok, PROMPT + i, CAP))
            tok, c2 = _counted(lambda: server.argmax_over_vocab(lg))
            if i == 0:
                counted["decode"] = _plus(c, c2)
            logits.append(whole(lg))
    out["logits"] = torch.stack(logits).numpy()
    out["counted"] = counted
    out["derived"] = {"prefill": _derived(dryrun.serve_collectives(cfg, mesh, SB, PROMPT, CAP)),
                      "decode": _derived(dryrun.serve_collectives(cfg, mesh, SB, 1, CAP))}
    out["resident"] = (fsdp.resident_bytes(server.model.param_tree()),
                       fsdp.resident_bytes(cache))
    cell = dryrun.cell_bytes(cfg, ShapeSpec("tp", "decode", CAP, SB), mesh)
    out["cell"] = (cell["params_bytes"], cell["cache_bytes"])
    return out


def _ranks(root):
    """Each configuration served on (1, 4) and (2, 2) from the step-0
    checkpoint, its init shards and leaf roles, and the constrain sites
    the serving checked."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives, fsdp
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.model import Model, param_defs
    from repro_torch.models.config import flatten
    torch.set_num_threads(1)
    meshes = {"m14": make_mesh_for(model_parallel=4, device="cpu"),
              "m22": make_mesh_for(model_parallel=2, device="cpu")}
    out = {"rank": dist.get_rank(), "coords": {k: collectives._coord(m)
                                              for k, m in meshes.items()}}
    sh.CHECKS.clear()
    for name in ARCHS:
        cfg = _cfg(name)
        res = out[name] = {}
        for key, mesh in meshes.items():
            res[key] = _serve(name, cfg, mesh, key, root)
            # this rank's shards against one device's seeded values
            rules = sh.rules_for(cfg)
            shards = fsdp.init_shards(Model(cfg, device="meta"), mesh, rules, seed=7,
                                      device="cpu", dtype=torch.float32)
            one = dict(Model(cfg, device="cpu", seed=7).named_parameters())
            layout = fsdp.param_layout(Model(cfg, device="meta"), mesh, rules)
            coord = collectives._coord(mesh)
            res[key]["init_equal"] = sorted(shards) == sorted(one) and all(
                torch.equal(shards[n], sh.local_shard(one[n].detach(), layout[n][1], mesh,
                                                      coord)) for n in one)
            res[key]["roles"] = {n: fsdp.leaf_role(cfg, mesh, rules, n)
                                 for n in flatten(param_defs(cfg))}
    out["checks"] = {"|".join(str(a) for a in k): v for k, v in sh.CHECKS.items()}
    return out


def start_runs(root, phase, ranks):
    """The reference's ``phase`` in a subprocess, started first, beside
    ``ranks`` on four gloo ranks: (the ranks' results, the reference's)."""
    rng = np.random.default_rng(4)
    np.save(root / "prompts.npy", rng.integers(0, 256, (SB, PROMPT)).astype(np.int32))
    write_step0(root, {name: _cfg(name) for name in ARCHS}, _hp())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_PROG, str(root), str(ROOT / "src"), json.dumps(HP),
         json.dumps({k: list(v) for k, v in ARCHS.items()}), json.dumps(MESHES),
         json.dumps([B, S, NEW, CAP]), phase], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = multihost.spawn(ranks, 4, str(root), device="cpu",
                               init_file=str(root / "rendezvous"), timeout=400)
    finally:
        stdout, stderr = ref.communicate(timeout=400)
    assert ref.returncode == 0 and "REF_OK" in stdout, stderr[-3000:]
    with open(root / f"ref_{phase}.json") as f:
        return port, json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm_tp")
    port, refout = start_runs(root, "serve", _ranks)
    return port, refout, root


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_server_matches_reference_mesh_run(runs, name, mesh):
    port, ref, root = runs
    want = np.load(root / f"ref_{name}_{mesh}_logits.npy")
    v = _cfg(name).vocab_size
    for p in port:
        got = p[name][mesh]
        assert np.array_equal(got["tokens"], np.asarray(ref[name][mesh]))
        mine = want[:, got["row0"]:got["row0"] + got["logits"].shape[1], :v]
        err = np.abs(got["logits"][..., :v] - mine).max()
        assert err <= LOGIT_TOL * np.abs(want[..., :v]).max(), err
        assert np.array_equal(got["tokens"], port[0][name][mesh]["tokens"])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_collectives_equal_the_derivation(runs, name):
    """The prefill's and one decode step's collectives on both meshes (the
    train step's: test_torch_lm_tp_train.py)."""
    port, _, _ = runs
    for p in port:
        res = p[name]
        for mesh in MESHES:
            for phase in ("prefill", "decode"):
                assert res[mesh]["counted"][phase] == res[mesh]["derived"][phase], \
                    (mesh, phase, p["rank"])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_resident_bytes_equal_cell_bytes(runs, name):
    port, _, _ = runs
    for p in port:
        for mesh in MESHES:
            assert p[name][mesh]["resident"] == p[name][mesh]["cell"], (mesh, p["rank"])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_init_shards_equal_one_device(runs, name):
    port, _, _ = runs
    assert all(p[name][m]["init_equal"] for p in port for m in MESHES)


def test_init_transient_is_one_layer():
    from repro_torch.distributed import fsdp
    cfg = get_config("qwen2.5-32b")
    peak = fsdp.init_transient_bytes(cfg)
    layer = 4 * cfg.d_model * cfg.d_ff
    print(f"qwen2.5-32b: largest f32 draw of the init {peak:,} bytes (one layer's "
          f"mlp leaf {layer:,}; the vocab leaves {4 * cfg.d_model * cfg.vocab_padded:,}; "
          f"the stacked mlp leaf drawn whole would be {cfg.n_layers * layer:,})")
    assert peak == 4 * cfg.d_model * cfg.vocab_padded < cfg.n_layers * layer


def test_every_constrain_site_checks_its_block(runs):
    port, _, _ = runs
    for p in port:
        keys = set(p["checks"])
        for axes in (("batch", "seq", "heads", "head_dim"),
                     ("batch", "seq", "kv_heads", "head_dim"),
                     ("batch", "kv_heads", "qgroup", None, None),
                     ("batch", None, "heads", None, None),
                     ("batch", None, "qgroup", "attn_q_seq", None),
                     ("batch", None, None, "heads", None),
                     ("batch", "seq", "mlp"), ("batch", "seq", "vocab"),
                     ("batch", "seq", "embed"), ("batch", "seq", "kv_lora"),
                     ("batch", "cache_seq", "kv_heads", "head_dim"),
                     ("batch", "cache_seq", "kv_lora"), ("batch", "cache_seq", None)):
            assert "|".join(str(a) for a in axes) in keys, axes


def test_roles_follow_the_split(runs):
    """The q-group case keeps q/o local and gathers K/V; so does the
    q-sequence case with the heads split (4 heads on (1, 4)), whose K/V
    gradients come from each rank's rows; SSM B/C and MLA's latents are
    partial."""
    port, _, _ = runs
    roles = port[0]
    assert roles["chatglm3"]["m14"]["roles"]["stages.layers.attn.wq"] == "local"
    assert roles["chatglm3"]["m14"]["roles"]["stages.layers.attn.wk"] == "partial"
    assert roles["chatglm3"]["m22"]["roles"]["stages.layers.attn.wk"] == "local"
    assert roles["qwen"]["m14"]["roles"]["stages.layers.attn.wq"] == "local"
    assert roles["qwen"]["m14"]["roles"]["stages.layers.attn.wk"] == "partial"
    assert roles["qwen"]["m14"]["roles"]["stages.layers.ffn.wg"] == "local"
    assert roles["zamba2"]["m14"]["roles"]["stages.groups.mixer.wB"] == "partial"
    assert roles["zamba2"]["m14"]["roles"]["stages.groups.mixer.wx"] == "local"
    assert roles["dsv2"]["m14"]["roles"]["stages.dense_layers.attn.wkv_a"] == "partial"
    assert roles["dsv2"]["m14"]["roles"]["embed.tok"] == "local"


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------

M14 = sh.AbstractMesh(("data", "model"), (1, 4))


def test_constrain_raises_on_a_wrong_layout():
    q = torch.zeros((2, 8, 4, 16))
    with sh.logical_sharding(M14), sh.local_batch(2, 2):
        axes = ("batch", "seq", "heads", "head_dim")
        assert sh.constrain(q, axes, {"heads": 16}) is q
        with pytest.raises(ValueError, match="block"):
            sh.constrain(q, axes, {"heads": 4})        # whole where it must be split
        with pytest.raises(ValueError, match="block"):
            sh.constrain(q, axes, {"heads": 32})       # another rank count's block
        cache = torch.zeros((2, 3, 2, 16))
        assert sh.constrain(cache, ("batch", "cache_seq", "kv_heads", "head_dim"),
                            {"cache_seq": 12, "kv_heads": 2}) is cache
        with pytest.raises(ValueError, match="block"):      # 6 does not split 4 ways
            sh.constrain(cache, ("batch", "cache_seq", "kv_heads", "head_dim"),
                         {"cache_seq": 6, "kv_heads": 2})
    with sh.logical_sharding(M14, sh.SMALL_DP_RULES), sh.local_batch(2, 8):
        assert sh.constrain(q, ("batch", "seq", "heads", "head_dim"), {"heads": 4}) is q


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2), (1, 16), (16, 16)])
def test_attn_mode_follows_score_axes(mesh):
    from repro_torch.models import layers
    am = sh.AbstractMesh(("data", "model"), mesh)
    for h, kv in ((32, 32), (32, 2), (40, 8), (8, 2), (4, 2), (16, 16), (128, 128)):
        with sh.logical_sharding(am):
            axes = layers._score_axes(kv, h // kv)
        mode = layers.attn_mode(am, sh.DEFAULT_RULES, h, kv)
        want = {"kv_heads": "kv", "heads": "qgroup", "attn_q_seq": "qseq"}
        got_axis = next(a for a in axes[1:4] if a in want)
        if got_axis == "attn_q_seq" and h % mesh[1] == 0:
            want["attn_q_seq"] = "qseq_heads"       # the q sequence, the heads split
        assert mode == want[got_axis], (h, kv, mesh)
        assert layers.attn_mode(am, sh.SMALL_DP_RULES, h, kv) is None


TP_AXES = {"heads", "kv_heads", "mlp", "shared_mlp", "vocab", "ssm_heads", "experts"}


@pytest.mark.parametrize("arch", sorted(ALIASES))
def test_no_model_gather_of_a_tensor_parallel_leaf(arch):
    """On both production meshes, a leaf whose spec puts ``model`` on a
    tensor-parallel axis keeps its ``model`` block, but for the router of the
    expert-parallel island."""
    from types import SimpleNamespace

    from repro_torch.distributed import fsdp
    from repro_torch.models.model import _stages_for, param_defs
    from repro_torch.models.config import flatten
    cfg = get_config(arch)
    rules = sh.rules_for(cfg)
    for mesh in dryrun.PRODUCTION_MESHES.values():
        layout = fsdp.param_layout(SimpleNamespace(cfg=cfg, stages=_stages_for(cfg)), mesh,
                                   rules)
        axes = {}
        for n, p in flatten(param_defs(cfg)).items():
            if n.startswith("stages."):
                _, stage, rest = n.split(".", 2)
                axes[rest] = p.axes[1:]
            else:
                axes[n] = p.axes
        gathered = 0
        for name, (shape, spec) in layout.items():
            logical = axes[name.split(".", 2)[2] if name.startswith("blocks.") else name]
            on_tp = [a for e, a in zip(spec, logical) if "model" in sh.spec_axes(e)
                     and a in TP_AXES and rules.get(a) == "model"]
            gather, _ = dryrun.leaf_axes(cfg, mesh, rules, layout, name, ())
            if on_tp and "model" in gather:
                gathered += 1
                assert name.endswith("ffn.router"), name
        assert gathered == 0 or cfg.n_experts


def test_remat_recompute_sees_the_mesh_on_another_thread():
    """Autograd runs a backward, and so a remat recompute, on a thread of its
    own on the card: the recompute re-enters the forward's mesh and rules
    (a tensor-parallel layer there raises outside a mesh)."""
    import threading

    from repro_torch.models import model
    seen = []

    def fn(x):
        seen.append((sh.current_mesh(), sh.current_rules()))
        return x * x
    x = torch.ones(3, requires_grad=True)
    with sh.logical_sharding(M14, sh.SMALL_DP_RULES):
        y = model._remat(fn, x, early_stop=False)
    worker = threading.Thread(target=lambda: y.sum().backward())
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert len(seen) == 2 and seen[1][0] is M14 and seen[1][1] == sh.SMALL_DP_RULES
    assert sh.current_mesh() is None and torch.equal(x.grad, torch.full((3,), 2.0))
