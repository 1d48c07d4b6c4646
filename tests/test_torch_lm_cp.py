"""Context parallelism (the q-sequence case of the reference's
``_score_axes``) and Megatron-SP residual saves (``sp_activations``) on the
LM mesh against the reference's own mesh runs.

One spawn of four gloo CPU ranks runs every port phase; the reference runs
at the same time in subprocesses on four forced host devices with ``Auto``
mesh axes, as tests/test_torch_lm_tp.py does, and both start from one
reference-format checkpoint at step 0 per configuration, written from the
port's seeded init before either side starts.  Five reduced
configurations:

* qwen2.5 (4 heads on 2 KV heads, q/k/v bias) on (1, 4): neither the KV
  heads nor the group of 2 split 4 ways, the heads do: the q-sequence case
  with q relaid out from head blocks to row blocks;
* qwen2.5 with 6 heads on both sides, on (1, 4): 6, 2 and 3 do not divide
  4, so the heads stay whole (the production case) and each rank's rows are
  gathered before a whole ``wo``; with a q-chunk of 8 rows above a
  threshold of 8 on both sides its 16-token training sequences take the
  q-chunked path, each rank 2 rows of each chunk;
* qwen2-vl (M-RoPE, the vision stub) on (1, 4), served a prompt with
  vision embeddings and (t, h, w) positions that differ;
* deepseek-v3 with its own ``sp_activations`` (MLA, MoE, MTP) and 3 heads
  on both sides, on (2, 2): MLA's expanded attention in the q-sequence
  case (its heads whole) beside the expert-parallel island and SP, the MTP
  block's S - 1 rows padded to a multiple of ``model``;
* stablelm with ``sp_activations=True``, on (2, 2); both SP configurations
  with remat "full".

This file runs the three (1, 4) configurations; test_torch_lm_cp_sp.py
runs the two (2, 2) ones with the same checks (and the SP carry's), on
ranks and reference processes of its own, so that each file's fixture
stays near a minute.

The served prompts are 7 tokens long, which ``model`` does not divide:
each rank's rows of the q-sequence case are a block of the padded 8.

Checked, per configuration: ``Server(mesh=)``'s greedy tokens equal the
reference's, the prefill's and every decode step's logits within LOGIT_TOL
of the largest |logit|; one step's gradients per leaf on a fixed batch and
three training steps (losses, parameters) against the reference's at
tests/test_torch_lm_train.py's tolerances; one train step's, one prefill's
and one decode step's collectives equal to the dry run's derivation; under
SP, the carry that remat saves between entries is 1/m of the whole; every
rank checks the q-sequence scores' constraint; ``all_reduce``'s split fold
keeps the bits of the rank-order fold.  Without ranks: a rank's
causal block of query rows equals those rows of the whole rectangle, in
the q-chunked path too.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun, multihost, train
from repro_torch.models import layers
from test_torch_lm_tp import write_step0

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# name -> (arch, overrides of the reduced configuration on both sides, mesh)
ARCHS = {
    "qwen": ("qwen2_5_32b", {}, (1, 4)),
    "qwen6": ("qwen2_5_32b", {"n_heads": 6, "attn_q_chunk_threshold": 8}, (1, 4)),
    "vl": ("qwen2_vl_7b", {}, (1, 4)),
    "dsv3": ("deepseek_v3_671b", {"n_heads": 3, "remat": "full"}, (2, 2)),
    "stablelm": ("stablelm_3b", {"sp_activations": True, "remat": "full"}, (2, 2)),
}
QSEQ = ("qwen", "qwen6", "vl", "dsv3")
# the configurations each file's ranks run, and its reference processes:
# here the (1, 4) ones; the (2, 2) ones (MLA, SP) in test_torch_lm_cp_sp.py
HERE = ("qwen", "qwen6", "vl")
REF_GROUPS = (("qwen", "qwen6"), ("vl",))
TRAINED = tuple(ARCHS)        # three steps on both sides
HP = dict(total_steps=6, warmup_steps=2, grad_accum=2, lr=1e-3)
Q_CHUNK = 8                   # both packages' q-chunk, so qwen6 trains in two chunks
LOSS_RTOL, PARAM_RMS, LOGIT_TOL, GRAD_REL = 1e-5, 1e-2, 1e-4, 2e-3
B, S = 8, 16                  # training batch
SB, PROMPT, NEW = 4, 7, 4     # serving: 4 prompts of 7 tokens, 4 new tokens
CAP = 12                      # the caches' length


def _cfg(name):
    arch, over, _ = ARCHS[name]
    return reduced(get_config(arch)).with_overrides(**over)


def _hp(**over):
    return dataclasses.replace(train.TrainHParams(), **dict(HP, **over))


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b ** 2)), 1e-30))


def _prompt(name, rng) -> dict:
    """The serving request: tokens, and for the VLM two vision embeddings
    at (t, h, w) = (0, 0, 0) and (0, 0, 1) ahead of text from position 2."""
    cfg = _cfg(name)
    out = {"tokens": rng.integers(0, 256, (SB, PROMPT)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.standard_normal((SB, 2, cfg.frontend_dim)).astype(np.float32)
        pos = np.broadcast_to(np.arange(PROMPT, dtype=np.int32), (3, SB, PROMPT)).copy()
        pos[:, :, 1] = np.array([0, 0, 1])[:, None]
        out["positions"] = pos
    return out


_REF_PROG = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[2])
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.models import layers
from repro.distributed import checkpoint as ckpt
from repro.distributed.sharding import logical_sharding, rules_for
from repro.launch.specs import concrete_batch
from repro.launch.train import TrainHParams, abstract_train_state, train_loop
from repro.models.model import Model

root = sys.argv[1]
hp = dataclasses.replace(TrainHParams(), **json.loads(sys.argv[3]))
archs, trained = json.loads(sys.argv[4]), json.loads(sys.argv[6])
B, S, new, cap = json.loads(sys.argv[5])
layers.Q_CHUNK = json.loads(sys.argv[7])

def mesh(shape):
    return jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

# the step-0 weights, from the checkpoint both sides start from
params = {}
for name, (arch, over, shape) in archs.items():
    cfg = reduced(get_config(arch)).with_overrides(**over)
    like = abstract_train_state(Model(cfg), hp)
    params[name] = ckpt.restore(os.path.join(root, "step0_" + name), 0, like)[0]["params"]
out = {}
for name, (arch, over, shape) in archs.items():
    cfg = reduced(get_config(arch)).with_overrides(**over)
    m = mesh(shape)
    out[name] = {}
    if name in trained:
        _, out[name]["losses"], _ = train_loop(
            cfg, hp, batch=B, seq=S, steps=3, mesh=m, ckpt_dir=os.path.join(root, "ref_" + name),
            ckpt_every=3, log_every=100)
    model = Model(cfg)
    batch = concrete_batch(cfg, B, S, train=True, seed=3)
    with logical_sharding(m, rules_for(cfg)):
        grads = jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]))(params[name], batch)
    np.savez(os.path.join(root, f"ref_{name}_grads.npz"),
             **{"/".join(str(k.key) for k in path): np.asarray(g)
                for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]})
    prompt = {k: jnp.asarray(v) for k, v in np.load(os.path.join(root, f"prompt_{name}.npz")).items()}
    prefill = jax.jit(lambda p, b: model.prefill(p, b, seq_cap=cap))
    decode = jax.jit(model.decode_step)
    with logical_sharding(m, rules_for(cfg)):
        logits, cache = prefill(params[name], prompt)
        steps, toks = [np.asarray(logits)], []
        for i in range(new):
            tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
            toks.append(np.asarray(tok))
            logits, cache = decode(params[name], cache, tok,
                                   jnp.int32(prompt["tokens"].shape[1] + i))
            steps.append(np.asarray(logits))
    np.save(os.path.join(root, f"ref_{name}_logits.npy"), np.stack(steps))
    out[name]["tokens"] = np.concatenate(toks, axis=1).tolist()
json.dump(out, open(os.path.join(root, "ref_" + "_".join(archs) + ".json"), "w"))
print("REF_OK")
"""


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


def _restored(name, cfg, mesh, root, hp):
    """A sharded model holding the step-0 checkpoint's weights, its state."""
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import fsdp
    from repro_torch.models.model import Model
    model = fsdp.shard_model(Model(cfg, device="meta"), mesh, device="cpu")
    state = train.make_mesh_train_state(model, hp, mesh)
    restored, _ = ckpt.restore(os.path.join(root, "step0_" + name), 0, state, device="cpu",
                               shardings=train.train_shardings(model, hp, mesh))
    train.load_train_state(state, restored)
    return model, state


def _serve(name, cfg, mesh, root):
    """Generate from the step-0 weights on ``mesh``: the tokens, each step's
    logits (whole), the collectives of the prefill and of one decode step
    (each with its greedy pick)."""
    from repro_torch.distributed import collectives
    from repro_torch.launch.serve import Server
    model, _ = _restored(name, cfg, mesh, root, _hp())
    server = Server(cfg, model=model, mesh=mesh, device="cpu")
    prompt = {k: torch.from_numpy(v) for k, v in np.load(root / f"prompt_{name}.npz").items()}
    out = {"tokens": server.generate(prompt, NEW, seq_cap=CAP).numpy()}
    local, axes = server.local(prompt)
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
    return out


def _ranks(root, names):
    import torch.distributed as dist
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models.model import saved_carries
    from repro_torch.optim.optimizers import is_stacked, map_leaves
    torch.set_num_threads(1)
    layers.Q_CHUNK = Q_CHUNK
    meshes = {(1, 4): make_mesh_for(model_parallel=4, device="cpu"),
              (2, 2): make_mesh_for(model_parallel=2, device="cpu")}
    out = {"rank": dist.get_rank()}
    # all_reduce's split fold against the rank-order fold of the parts
    from repro_torch.distributed import collectives
    gen = torch.Generator().manual_seed(dist.get_rank())
    m14, out["fold_equal"] = meshes[(1, 4)], []
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(5, 1 << 17 | 1, generator=gen).to(dt)
        assert x.numel() * x.element_size() >= collectives.SPLIT_FOLD_BYTES
        out["fold_equal"].append(torch.equal(
            collectives.all_reduce(x, m14, ("model",)),
            collectives._fold(collectives.all_gather_axes(x, m14, ("model",)))))
    for name in names:
        cfg, mesh = _cfg(name), meshes[ARCHS[name][2]]
        res = out[name] = {}
        # three steps from the step-0 checkpoint
        if name in TRAINED:
            _, res["losses"], _ = train.train_loop(
                cfg, _hp(), batch=B, seq=S, steps=3, mesh=mesh, ckpt_every=3,
                ckpt_dir=os.path.join(root, "port_" + name), log_every=100, device="cpu")
        # one step's gradients on a fixed batch, gathered whole on rank 0
        batch = concrete_batch(cfg, B, S, train=True, seed=3, device="cpu")
        hp1 = _hp(grad_accum=1)
        model, state = _restored(name, cfg, mesh, root, hp1)
        step = train.make_train_step(model, hp1, mesh)
        sh.CHECKS.clear()
        step.grads(state, batch)
        res["checks"] = {"|".join(str(a) for a in k): v for k, v in sh.CHECKS.items()}
        grads = map_leaves(lambda p: [t.grad for t in p] if is_stacked(p) else p.grad,
                           state["params"])
        whole = ckpt.gather_tree(grads, step.shardings["params"])
        if whole is not None:
            res["grads"] = {n: t.float().numpy() for n, t in ckpt.leaf_paths(whole)}
        # one train step's collectives against the derivation, and the
        # carries its remat saved
        step = train.make_train_step(model, _hp(), mesh)
        with saved_carries() as res["saved"]:
            _, res["train_counted"] = _counted(lambda: step(state, batch))
        res["train_derived"] = _derived(dryrun.train_collectives(cfg, _hp(), mesh, B, S))
        res["n_entries"] = len(model.plan)
        del model, state, step
        res["serve"] = _serve(name, cfg, mesh, root)
    return out


def start_runs(root, names, ref_groups):
    """``names`` on four gloo ranks beside the reference's runs of them in
    one process per group of ``ref_groups`` (its jit compiles are the
    file's longest wait), started first: (the ranks' results, the
    reference's, per configuration)."""
    rng = np.random.default_rng(5)
    for name in ARCHS:
        np.savez(root / f"prompt_{name}.npz", **_prompt(name, rng))
    write_step0(root, {name: _cfg(name) for name in names}, _hp())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    refs = [subprocess.Popen(
        [sys.executable, "-c", _REF_PROG, str(root), str(ROOT / "src"), json.dumps(HP),
         json.dumps({k: [ARCHS[k][0], ARCHS[k][1], list(ARCHS[k][2])] for k in group}),
         json.dumps([B, S, NEW, CAP]), json.dumps(TRAINED), json.dumps(Q_CHUNK)], env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for group in ref_groups]
    try:
        port = multihost.spawn(_ranks, 4, root, names, device="cpu",
                               init_file=str(root / "rendezvous"), timeout=400)
    finally:
        done = [ref.communicate(timeout=400) for ref in refs]
    refout = {}
    for ref, (stdout, stderr), group in zip(refs, done, ref_groups):
        assert ref.returncode == 0 and "REF_OK" in stdout, stderr[-3000:]
        with open(root / ("ref_" + "_".join(group) + ".json")) as f:
            refout.update(json.load(f))
    return port, refout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm_cp")
    port, refout = start_runs(root, HERE, REF_GROUPS)
    return port, refout, root


@pytest.mark.parametrize("name", sorted(HERE))
def test_server_matches_reference_mesh_run(runs, name):
    port, ref, root = runs
    want = np.load(root / f"ref_{name}_logits.npy")
    v = _cfg(name).vocab_size
    for p in port:
        got = p[name]["serve"]
        assert np.array_equal(got["tokens"], np.asarray(ref[name]["tokens"]))
        mine = want[:, got["row0"]:got["row0"] + got["logits"].shape[1], :v]
        err = np.abs(got["logits"][..., :v] - mine).max()
        assert err <= LOGIT_TOL * np.abs(want[..., :v]).max(), err


@pytest.mark.parametrize("name", sorted(HERE))
def test_gradients_match_reference_per_leaf(runs, name):
    port, _, root = runs
    got = port[0][name]["grads"]
    want = dict(np.load(root / f"ref_{name}_grads.npz"))
    assert sorted(got) == sorted(want)
    for leaf, w in want.items():
        np.testing.assert_allclose(got[leaf], w, rtol=0, err_msg=leaf,
                                   atol=GRAD_REL * max(float(np.abs(w).max()), 1e-12))


def _files(directory, step):
    from repro_torch.distributed import checkpoint as ckpt
    with open(os.path.join(directory, f"step_{step}", "manifest.json")) as f:
        man = json.load(f)
    return {e["name"]: ckpt._load_npy(os.path.join(directory, f"step_{step}", e["file"]),
                                      e["dtype"]).float().numpy() for e in man["leaves"]}


@pytest.mark.parametrize("name", sorted(HERE))
def test_training_matches_reference_mesh_run(runs, name):
    port, ref, root = runs
    np.testing.assert_allclose(port[0][name]["losses"], ref[name]["losses"], rtol=LOSS_RTOL)
    assert all(p[name]["losses"] == port[0][name]["losses"] for p in port)
    got, want = _files(root / f"port_{name}", 3), _files(root / f"ref_{name}", 3)
    assert got.keys() == want.keys()
    for leaf in want:
        if leaf.endswith("/attn/bk"):
            # the key bias's gradient is 0 but for rounding on both sides,
            # and Adam moves each element by up to lr a step on its sign
            # (tests/test_torch_lm_tp.py's note)
            assert np.abs(got[leaf] - want[leaf]).max() <= 2 * HP["lr"] * 3, leaf
        elif leaf.startswith("params/"):
            assert rel_rms(got[leaf], want[leaf]) < PARAM_RMS, leaf


@pytest.mark.parametrize("name", sorted(HERE))
def test_collectives_equal_the_derivation(runs, name):
    port, _, _ = runs
    for p in port:
        res = p[name]
        assert res["train_counted"] == res["train_derived"], p["rank"]
        for phase in ("prefill", "decode"):
            assert res["serve"]["counted"][phase] == res["serve"]["derived"][phase], \
                (phase, p["rank"])
    if name in QSEQ:     # the rows' gathers (or relayouts) of the q-sequence case
        assert port[0][name]["train_counted"]["all-gather"]["count"] > 0


def test_all_reduce_split_fold_keeps_the_bits(runs):
    """Above SPLIT_FOLD_BYTES on four ranks each member folds a quarter of
    the elements: the bits of every rank's fold of the gathered parts."""
    port, _, _ = runs
    assert all(p["fold_equal"] == [True, True] for p in port)


@pytest.mark.parametrize("name", sorted(HERE))
def test_the_carry_and_score_constraints_are_checked(runs, name):
    port, _, _ = runs
    qseq = "batch|None|qgroup|attn_q_seq|None"
    carry = "batch|attn_q_seq|embed"
    # a forward of the gradient step: once a layer (again in remat's
    # recompute), and once a q-chunk of qwen6's (16 rows in chunks of
    # Q_CHUNK); once in the MTP block
    cfg = _cfg(name)
    want = (cfg.n_layers * (S // Q_CHUNK if name == "qwen6" else 1)
            * (2 if cfg.remat == "full" else 1) + cfg.mtp_depth)
    for p in port:
        checks = p[name]["checks"]
        assert checks.get(qseq, 0) == (want if name in QSEQ else 0), (name, sorted(checks))
        assert (carry in checks) == _cfg(name).sp_activations, (name, sorted(checks))


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4, 3])
@pytest.mark.parametrize("s, threshold, chunk", [(16, 8192, layers.Q_CHUNK), (15, 8192, 8),
                                                  (24, 8, 8), (20, 8, 8)])
def test_a_ranks_rows_equal_the_rectangles(monkeypatch, m, s, threshold, chunk):
    """Each rank's causal block of query rows (one block, or S/m rows of
    every q-chunk; a sequence, a ragged last chunk or, where m does not
    divide the q-chunk, every chunk padded, a chunk's dummy rows before the
    next chunk's) against the whole K/V equals those rows of the whole
    rectangle."""
    monkeypatch.setattr(layers, "Q_CHUNK", chunk)
    gen = torch.Generator().manual_seed(0)
    b, kv, g, d = 2, 2, 3, 8
    q = torch.randn(b, s, kv, g, d, generator=gen, dtype=torch.float64)
    k = torch.randn(b, s, kv, d, generator=gen, dtype=torch.float64)
    v = torch.randn(b, s, kv, d, generator=gen, dtype=torch.float64)
    whole = layers._sdpa_full(q, k, v, causal=True)
    chunks = layers.cp_chunks(s, m, threshold)
    pos = layers.cp_positions(chunks, s)
    assert len(chunks) == (1 if s <= threshold else -(-s // chunk))
    assert sorted(p for p in pos if p >= 0) == list(range(s))
    qp = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)[:, [p if p >= 0 else s for p in pos]]
    seen = []
    for r in range(m):
        rows = layers.cp_rows(chunks, m, r)
        assert len(rows) == len(pos) // m
        out = layers.cp_attend(qp[:, list(rows)], k, v, causal=True, chunks=chunks, m=m, r=r,
                               n_kv=kv, group=g)
        assert torch.isfinite(out).all()
        real = [i for i, row in enumerate(rows) if pos[row] >= 0]
        torch.testing.assert_close(out[:, real], whole[:, [pos[rows[i]] for i in real]],
                                   rtol=1e-12, atol=1e-12)
        seen += [pos[rows[i]] for i in real]
    assert sorted(seen) == list(range(s))


@pytest.mark.parametrize("s, m, want", [(15, 4, [(0, 16)]), (7, 4, [(0, 8)]), (16, 4, [(0, 16)]),
                                        (15, 2, [(0, 16)])])
def test_rows_that_do_not_divide_are_padded(s, m, want):
    """Below the threshold the rows are one block padded to a multiple of
    m, each rank's a contiguous part of it."""
    assert layers.cp_chunks(s, m, 8192) == want
    per = want[0][1] // m
    assert [layers.cp_rows(want, m, r) for r in range(m)] == [
        tuple(range(r * per, (r + 1) * per)) for r in range(m)]
