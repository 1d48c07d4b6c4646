"""The port's checkpoints (repro_torch.distributed.checkpoint) against
repro's: the cases of tests/distributed/test_checkpoint.py, and both
directions across packages, bit for bit: a train state (f32 parameters,
bf16 moments, the int32 step) written by the port and read by
repro.distributed.checkpoint.restore into the reference's train state, and
one written by the reference and read by the port."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.distributed import checkpoint as jckpt
from repro.launch import train as jtrain
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.launch import train
from repro_torch.models.convert import params_from_reference, stack_tree
from repro_torch.models.model import Model
from test_torch_lm_model import port_weights
from test_torch_lm_train import reference_train_state

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((4, 8), generator=g),
                   "b": torch.zeros((8,), dtype=torch.bfloat16)},
        "opt": {"mu": {"w": torch.ones((4, 8))}},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _leaves(tree):
    return [leaf for _, leaf in ckpt.leaf_paths(tree)]


def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t, extra={"data_step": 3})
    restored, manifest = ckpt.restore(str(tmp_path), 7, t)
    assert manifest["extra"]["data_step"] == 3
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_step(tmp_path):
    assert ckpt.latest_step(str(tmp_path)) is None
    for s in (5, 10, 20):
        ckpt.save(str(tmp_path), s, _tree())
    assert ckpt.latest_step(str(tmp_path)) == 20


def test_missing_leaf_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), 1, {"b": torch.zeros(3)})


def test_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(4)})


def test_async_writer_and_gc(tmp_path):
    w = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        w.save(s, _tree(s))
    w.close()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_3", "step_4"]
    restored, _ = ckpt.restore(str(tmp_path), 4, _tree())
    assert torch.equal(restored["params"]["w"], _tree(4)["params"]["w"])


def test_no_tmp_dirs_left(tmp_path):
    ckpt.save(str(tmp_path), 3, _tree())
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_async_save_copies_before_it_enqueues(tmp_path):
    """The writer holds host copies: tensors updated in place after save()
    (as the optimizer updates them) do not reach the checkpoint."""
    t = _tree()
    want = t["params"]["w"].clone()
    w = ckpt.AsyncCheckpointer(str(tmp_path))
    w.save(1, t)
    t["params"]["w"].add_(1.0)
    t["step"].add_(1)
    w.close()
    restored, _ = ckpt.restore(str(tmp_path), 1, _tree())
    assert torch.equal(restored["params"]["w"], want)
    assert int(restored["step"]) == 7


def test_list_leaf_written_stacked(tmp_path):
    """A stage leaf held per layer is one stacked leaf on disk and comes
    back as a list of its rows, on the like leaf's device and dtype."""
    layers = [torch.full((2, 3), float(i)) for i in range(4)]
    ckpt.save(str(tmp_path), 1, {"stages": {"w": layers}})
    manifest = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert manifest["leaves"] == [{"name": "stages/w", "file": "stages__w.npy",
                                   "shape": [4, 2, 3], "dtype": "float32"}]
    like = {"stages": {"w": [torch.empty((2, 3), dtype=torch.bfloat16) for _ in range(4)]}}
    restored, _ = ckpt.restore(str(tmp_path), 1, like)
    assert [float(x[0, 0]) for x in restored["stages"]["w"]] == [0.0, 1.0, 2.0, 3.0]
    assert restored["stages"]["w"][0].dtype == torch.bfloat16


def test_bf16_file_bytes_equal_to_reference(tmp_path):
    """A bf16 leaf's .npy is byte-identical to the reference's (a <V2
    record array of the raw bits) and its manifest entry the same."""
    bits = np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    jckpt.save(str(tmp_path / "ref"), 1, {"x": jnp.asarray(bits, jnp.bfloat16)})
    ckpt.save(str(tmp_path / "port"), 1, {"x": torch.from_numpy(bits).to(torch.bfloat16)})
    ref_dir, port_dir = tmp_path / "ref" / "step_1", tmp_path / "port" / "step_1"
    assert (ref_dir / "x.npy").read_bytes() == (port_dir / "x.npy").read_bytes()
    assert (json.loads((ref_dir / "manifest.json").read_text())
            == json.loads((port_dir / "manifest.json").read_text()))


# ---------------------------------------------------------------------------
# train states across packages
# ---------------------------------------------------------------------------

ARCH = "stablelm_3b"
OVER = dict(opt_dtype="bfloat16")     # bf16 moments beside f32 parameters
HP = dict(optimizer="adamw", warmup_steps=0, total_steps=10, grad_accum=1, lr=1e-3)


@pytest.fixture(scope="module")
def ref_state():
    """The reference's model, hyperparameters and a train state one step in
    (moments not zero), its train state built around the port's seeded
    weights (test_torch_lm_model.port_weights)."""
    from repro.launch.specs import concrete_batch
    jcfg = jreduced(jget_config(ARCH)).with_overrides(**OVER)
    jm = JModel(jcfg)
    hp = dataclasses.replace(jtrain.TrainHParams(), **HP)
    state = reference_train_state(jcfg, hp, port_weights(ARCH, **OVER))
    state, _ = jax.jit(jtrain.make_train_step(jm, hp))(
        state, concrete_batch(jcfg, 2, 8, train=True))
    return jm, hp, state


def _port_state(params_tree):
    cfg = reduced(get_config(ARCH)).with_overrides(**OVER)
    model = params_from_reference(params_tree, Model(cfg, device="cpu"))
    return model, train.make_train_state(model, train.TrainHParams(**HP))


def _assert_trees_bit_equal(port_tree, ref_tree):
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got = dict(ckpt.leaf_paths(stack_tree(port_tree)))
    assert sorted(got) == sorted("/".join(str(k.key) for k in p) for p, _ in ref_flat)
    dtypes = set()
    for path, want in ref_flat:
        name = "/".join(str(k.key) for k in path)
        g, w = got[name], np.asarray(want)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
        g = (g.view(torch.int16) if g.dtype == torch.bfloat16 else g).numpy()
        assert g.shape == w.shape and g.tobytes() == w.tobytes(), name
        dtypes.add(str(w.dtype))
    assert {"float32", "bfloat16", "int32"} <= dtypes


def test_port_checkpoint_read_by_reference(tmp_path, ref_state):
    """A state the port trained one step (its own bf16 moments), saved by
    the port, restored by the reference into its abstract train state."""
    jm, hp, ref_state = ref_state
    model, state = _port_state(jax.tree.map(np.asarray, ref_state["params"]))
    from repro_torch.launch.specs import concrete_batch
    state, _ = train.make_train_step(model, train.TrainHParams(**HP))(
        state, concrete_batch(model.cfg, 2, 8, train=True, seed=1, device="cpu"))
    assert int(state["step"]) == 1
    ckpt.save(str(tmp_path), 1, state, extra={"data_step": 1})
    restored, manifest = jckpt.restore(str(tmp_path), 1, jtrain.abstract_train_state(jm, hp))
    assert manifest["extra"] == {"data_step": 1} and int(restored["step"]) == 1
    assert restored["opt"]["mu"]["stages"]["layers"]["ffn"]["wg"].dtype == jnp.bfloat16
    _assert_trees_bit_equal(state, restored)


def test_reference_checkpoint_read_by_port(tmp_path, ref_state):
    _, _, ref_state = ref_state
    jckpt.save(str(tmp_path), 3, ref_state, extra={"data_step": 3})
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32).astype(a.dtype),
                         jax.tree.map(np.asarray, ref_state["params"]))
    model, state = _port_state(zeros)
    restored, manifest = ckpt.restore(str(tmp_path), 3, state)
    train.load_train_state(state, restored)
    assert manifest["extra"] == {"data_step": 3}
    assert state["opt"]["mu"]["stages"]["layers"]["ffn"]["wg"].dtype == torch.bfloat16
    _assert_trees_bit_equal(state, ref_state)
    # the parameters reached the model's own tensors
    assert torch.equal(model.blocks[1]["ffn"]["wg"].detach(),
                       torch.from_numpy(np.array(ref_state["params"]["stages"]["layers"]
                                                 ["ffn"]["wg"][1])))
