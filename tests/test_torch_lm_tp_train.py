"""Tensor parallelism in training on the LM mesh against the reference's own
mesh run: the five reduced configurations of test_torch_lm_tp.py (which
serves them) trained three steps on (2, 2) from one step-0 checkpoint per
configuration, the losses and parameters within
tests/test_torch_lm_train.py's tolerances, and one train step's
collectives (kind, count, bytes) equal to the dry run's derivation.  One
spawn of four gloo CPU ranks beside the reference's training in a
subprocess on four forced host devices, started first."""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.launch import dryrun, train
from test_torch_lm_tp import (ARCHS, B, HP, LOSS_RTOL, PARAM_RMS, S, _cfg, _counted, _derived, _hp,
                             start_runs)

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b ** 2)), 1e-30))


def _train_ranks(root):
    """Each configuration's training on (2, 2): three steps from the step-0
    checkpoint, and one step's collectives beside the derivation."""
    import torch.distributed as dist
    from repro_torch.distributed import fsdp
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models.model import Model
    torch.set_num_threads(1)
    m22 = make_mesh_for(model_parallel=2, device="cpu")
    out = {"rank": dist.get_rank()}
    for name in ARCHS:
        cfg = _cfg(name)
        res = out[name] = {}
        # three steps on (2, 2) from the step-0 checkpoint
        _, res["losses"], _ = train.train_loop(
            cfg, _hp(), batch=B, seq=S, steps=3, mesh=m22, ckpt_every=3,
            ckpt_dir=os.path.join(root, "port_" + name), log_every=100, device="cpu")
        # one step's collectives against the derivation
        model = fsdp.shard_model(Model(cfg, device="meta"), m22, device="cpu")
        state = train.make_mesh_train_state(model, _hp(), m22)
        step = train.make_train_step(model, _hp(), m22)
        batch = concrete_batch(cfg, B, S, train=True, seed=3, device="cpu")
        _, res["train_counted"] = _counted(lambda: step(state, batch))
        res["train_derived"] = _derived(dryrun.train_collectives(cfg, _hp(), m22, B, S))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm_tp_train")
    port, refout = start_runs(root, "train", _train_ranks)
    return port, refout, root


def _files(directory, step):
    from repro_torch.distributed import checkpoint as ckpt
    with open(os.path.join(directory, f"step_{step}", "manifest.json")) as f:
        man = json.load(f)
    return {e["name"]: ckpt._load_npy(os.path.join(directory, f"step_{step}", e["file"]),
                                      e["dtype"]).float().numpy() for e in man["leaves"]}


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_training_matches_reference_mesh_run(runs, name):
    port, ref, root = runs
    np.testing.assert_allclose(port[0][name]["losses"], ref[name]["losses"], rtol=LOSS_RTOL)
    assert all(p[name]["losses"] == port[0][name]["losses"] for p in port)
    got, want = _files(root / f"port_{name}", 3), _files(root / f"ref_{name}", 3)
    assert got.keys() == want.keys()
    for leaf in want:
        if leaf.endswith("/attn/bk"):
            # the key bias adds q.bk to every score of a query's row, which the
            # softmax cancels: its gradient is 0 but for rounding, on both
            # sides, and Adam moves each element by up to lr a step on the
            # sign of that rounding (tests/test_torch_lm_train.py's note)
            assert np.abs(got[leaf] - want[leaf]).max() <= 2 * HP["lr"] * 3, leaf
        elif leaf.startswith("params/"):
            assert rel_rms(got[leaf], want[leaf]) < PARAM_RMS, leaf


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_train_collectives_equal_the_derivation(runs, name):
    port, _, _ = runs
    for p in port:
        res = p[name]
        assert res["train_counted"] == res["train_derived"], p["rank"]
        assert res["train_counted"]["all-reduce"]["count"] > 0
