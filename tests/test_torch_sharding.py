"""The port's logical-axis rules (repro_torch.distributed.sharding) against
repro's: every case of tests/distributed/test_sharding_rules.py; every leaf
of every configuration's train state (its default optimizer, with the
int8 compression's residuals), parameters, caches and batches on six meshes
under both rule profiles, the reference's side on jax AbstractMeshes; the
attention scores' axes; and the block each mesh position owns against
jax's devices_indices_map on forced host devices (a subprocess)."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro_torch.configs import ALIASES, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.checkpoint import leaf_paths
from repro_torch.launch import specs, train
from repro_torch.models import layers
from repro_torch.models.model import Model

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

MESHES = {
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "2x2": (("data", "model"), (2, 2)),
    "4x1": (("data", "model"), (4, 1)),
    "1x4": (("data", "model"), (1, 4)),
    "2x1x2": (("pod", "data", "model"), (2, 1, 2)),
}
ARCHS = sorted(ALIASES)


def _meshes(key):
    names, sizes = MESHES[key]
    return sh.AbstractMesh(names, sizes), JAbstractMesh(sizes, names)


class _FakeMesh:
    """Duck-typed mesh with arbitrary axis sizes (no devices needed)."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


M16 = _FakeMesh({"data": 16, "model": 16})
M3 = _FakeMesh({"pod": 2, "data": 16, "model": 16})

# (shape, axes, mesh, param_retry, the reference test's expected spec)
RULE_CASES = {
    "basic_mapping": ((128, 1024), ("embed", "mlp"), M16, False, ("data", "model")),
    "divisibility_fallback": ((4096, 2, 128), ("embed", "kv_heads", "head_dim"), M16, False,
                              ("data",)),
    "param_retry_uses_head_dim": ((4096, 40, 128), ("embed", "heads", "head_dim"), M16, True,
                                  ("data", None, "model")),
    "retry_skipped_for_activations": ((256, 4096, 40, 128),
                                      ("batch", "seq", "heads", "head_dim"), M16, True,
                                      ("data",)),
    "tiny_batch_falls_back": ((8, 4096, 40, 128), ("batch", "seq", "heads", "head_dim"), M16,
                              True, ()),
    "batch_multi_axis_multipod": ((256, 4096), ("batch", "seq"), M3, False,
                                  (("pod", "data"),)),
    "axis_used_once": ((65280, 4096), ("vocab", "embed"), M16, False, ("model", "data")),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_cases_match_reference(case):
    shape, axes, mesh, retry, want = RULE_CASES[case]
    got = sh.logical_to_spec(shape, axes, mesh, sh.DEFAULT_RULES, param_retry=retry)
    ref = jsh.logical_to_spec(shape, axes, mesh, jsh.DEFAULT_RULES, param_retry=retry)
    assert got == tuple(ref) == want


def test_constrain_is_identity_without_and_with_a_mesh():
    x = torch.ones((4, 4))
    assert sh.constrain(x, ("batch", "embed")) is x
    with sh.logical_sharding(M16), sh.local_batch(4):
        assert sh.constrain(x, ("batch", "embed")) is x
        with pytest.raises(ValueError, match="block"), sh.local_batch(2):
            sh.constrain(x, ("batch", "embed"))


def test_tree_shardings_structure():
    ab = {"w": torch.empty((4, 8), device="meta"), "b": torch.empty((8,), device="meta")}
    out = sh.tree_shardings(ab, {"w": ("embed", "mlp"), "b": ("mlp",)}, M16)
    assert set(out) == {"w", "b"} and out["w"].mesh.axis_names == ("data", "model")
    with pytest.raises(ValueError, match="mismatch"):
        sh.tree_shardings(ab, {"w": ("embed", "mlp")}, M16)


def test_is_axes_leaf():
    assert sh.is_axes_leaf(("a", None, "b"))
    assert sh.is_axes_leaf(())
    assert not sh.is_axes_leaf(("a", 3))
    assert not sh.is_axes_leaf("a")


def test_profiles_and_rules_for_equal_reference():
    assert sh.DEFAULT_RULES == jsh.DEFAULT_RULES
    assert sh.SMALL_DP_RULES == jsh.SMALL_DP_RULES
    for a in ARCHS:
        assert sh.rules_for(get_config(a)) == jsh.rules_for(jget_config(a))


# ---------------------------------------------------------------------------
# every leaf of every configuration
# ---------------------------------------------------------------------------

_TREES: dict = {}


def _hp(cfg_name):
    return dataclasses.replace(train.default_hparams_for(get_config(cfg_name)),
                               grad_compression=True)


def _trees(arch):
    """(port leaves, reference leaves): name -> (shape, dtype name, axes)
    for the train state, the decode cache and each shape's batch."""
    if arch in _TREES:
        return _TREES[arch]
    cfg, jcfg = get_config(arch), jget_config(arch)
    model, jmodel = Model(cfg, device="meta"), JModel(jcfg)
    hp = _hp(arch)
    jhp = jtrain.TrainHParams(**dataclasses.asdict(hp))
    sh_ = JSHAPES["decode_32k"]
    port = {"state": (train.abstract_train_state(model, hp), train.train_state_specs(model, hp)),
            "cache": (model.abstract_cache(sh_.global_batch, sh_.seq_len),
                      model.cache_specs(sh_.global_batch, sh_.seq_len))}
    ref = {"state": (jtrain.abstract_train_state(jmodel, jhp),
                     jtrain.train_state_specs(jmodel, jhp)),
           "cache": (jmodel.abstract_cache(sh_.global_batch, sh_.seq_len),
                     jmodel.cache_specs(sh_.global_batch, sh_.seq_len))}
    for name, shp in SHAPES.items():
        port[name] = ({k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                       for k, v in specs.input_specs(cfg, shp).items()},
                      specs.batch_logical_axes(cfg, shp))
        ref[name] = (jspecs.input_specs(jcfg, JSHAPES[name]),
                     jspecs.batch_logical_axes(jcfg, JSHAPES[name]))
    _TREES[arch] = (port, ref)
    return _TREES[arch]


def _port_leaves(abstract, axes):
    names = leaf_paths(abstract)
    ax = dict(leaf_paths(axes)) if axes else {}
    return {n: (tuple(a.shape), str(a.dtype).replace("torch.", ""), ax.get(n, ()))
            for n, a in names}


def _ref_leaves(abstract, axes):
    flat, _ = jax.tree_util.tree_flatten_with_path(abstract)
    flat_ax = jax.tree_util.tree_flatten_with_path(axes, is_leaf=jsh.is_axes_leaf)[0]
    ax = {"/".join(str(k.key) for k in p): a for p, a in flat_ax}
    out = {}
    for p, a in flat:
        n = "/".join(str(k.key) for k in p)
        out[n] = (tuple(a.shape), str(np.dtype(a.dtype)), ax.get(n, ()))
    return out


@pytest.mark.parametrize("profile", ["default", "small_dp"])
@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_spec_equals_reference(arch, mesh_key, profile):
    """Train state (params, optimizer state, step, ef_err), decode cache and
    every shape's batch: same leaves, shapes, dtypes and specs."""
    port, ref = _trees(arch)
    mesh, jmesh = _meshes(mesh_key)
    rules, jrules = sh.PROFILES[profile], jsh.PROFILES[profile]
    n = 0
    for part in port:
        mine, theirs = _port_leaves(*port[part]), _ref_leaves(*ref[part])
        assert sorted(mine) == sorted(theirs), part
        for name, (shape, dtype, axes) in mine.items():
            rshape, rdtype, raxes = theirs[name]
            assert (shape, dtype, tuple(axes)) == (rshape, rdtype, tuple(raxes)), name
            retry = part in ("state", "cache")
            got = sh.logical_to_spec(shape, axes, mesh, rules, param_retry=retry)
            want = jsh.logical_to_spec(shape, raxes, jmesh, jrules, param_retry=retry)
            assert got == tuple(want), (part, name)
            n += 1
    assert n > 20


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
def test_score_axes_equal_reference(mesh_key):
    mesh, jmesh = _meshes(mesh_key)
    for a in ARCHS:
        cfg = get_config(a)
        if not cfg.n_heads:
            continue
        kv = cfg.n_kv_heads or cfg.n_heads
        g = cfg.n_heads // kv
        with sh.logical_sharding(mesh), jsh.logical_sharding(jmesh):
            assert layers._score_axes(kv, g) == jlayers._score_axes(kv, g), a
    assert layers._score_axes(2, 16) == ("batch", "kv_heads", "qgroup", None, None)


# ---------------------------------------------------------------------------
# the block each position owns, against jax's devices_indices_map
# ---------------------------------------------------------------------------

INDEX_CASES = [
    ((2, 2), ("data", "model"), (8, 12), ("data", "model")),
    ((2, 2), ("data", "model"), (8, 12, 4), ("model", None, "data")),
    ((2, 2), ("data", "model"), (8, 6), (("data", "model"),)),
    ((4, 1), ("data", "model"), (8, 6), ("data", "model")),
    ((1, 4), ("data", "model"), (16, 8, 4), ("model",)),
    ((2, 1, 2), ("pod", "data", "model"), (8, 4), (("pod", "data"), "model")),
    ((2, 2, 2), ("pod", "data", "model"), (16, 4), (("pod", "data", "model"),)),
    ((2, 4), ("data", "model"), (4, 8, 2), (None, ("model",), "data")),
]

_PROG = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
out = []
for sizes, names, shape, spec in json.loads(sys.argv[1]):
    n = int(np.prod(sizes))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(sizes), tuple(names),
                             axis_types=(jax.sharding.AxisType.Auto,) * len(names))
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    rows = []
    for d, sl in idx.items():
        pos = [int(i) for i in np.argwhere(mesh.devices == d)[0]]
        rows.append([pos, [[s.start or 0, shape[i] if s.stop is None else s.stop]
                           for i, s in enumerate(sl)]])
    out.append(rows)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_indices():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _PROG, json.dumps(INDEX_CASES)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("i", range(len(INDEX_CASES)))
def test_shard_slices_equal_devices_indices_map(jax_indices, i):
    sizes, names, shape, spec = INDEX_CASES[i]
    mesh = sh.AbstractMesh(names, sizes)
    rows = jax_indices[i]
    assert len(rows) == len(sh.mesh_coords(mesh))
    for pos, want in rows:
        coord = dict(zip(names, pos))
        got = sh.shard_slices(shape, spec, mesh, coord)
        assert [[s.start or 0, shape[d] if s.stop is None else s.stop]
                for d, s in enumerate(got)] == want, (coord, spec)
    # and the blocks reassemble the array
    full = torch.arange(int(np.prod(shape))).reshape(shape)
    blocks = [sh.local_shard(full, spec, mesh, c) for c in sh.mesh_coords(mesh)]
    assert all(tuple(b.shape) == sh.shard_shape(shape, spec, mesh) for b in blocks)
    assert torch.equal(sh.from_shards(blocks, spec, mesh), full)
