"""The port's dry run (repro_torch.launch.dryrun) against repro's: the cases
of tests/launch/test_dryrun_units.py on the reference's functions (cell
skips, the runnable cell count, parse_collectives / _shape_bytes,
model_flops_estimate of every cell, the input structures); the per-device
argument bytes of every runnable cell on both production meshes equal to
the bytes that the reference's specs give its abstract trees on jax
AbstractMeshes; and ``--all`` on the CPU in seconds with no ranks."""

import math
import time

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import all_configs as jall_configs
from repro.configs import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import cell_status as jcell_status
from repro.configs.shapes import runnable_cells as jrunnable_cells
from repro.distributed import sharding as jsh
from repro.launch import dryrun as jdryrun
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro.models.model import Model as JModel
from repro_torch.configs import ALIASES, all_configs, get_config
from repro_torch.configs.shapes import SHAPES, cell_status, runnable_cells
from repro_torch.distributed.checkpoint import leaf_paths
from repro_torch.launch import dryrun, specs

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

JMESHES = {"pod16x16": JAbstractMesh((16, 16), ("data", "model")),
           "pod2x16x16": JAbstractMesh((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, s) for a in sorted(ALIASES) for s in SHAPES if cell_status(get_config(a), SHAPES[s])[0]]

HLO = """
  %ar = bf16[8,128]{1,0} all-reduce(%x), replica_groups={}
  %ag.1 = f32[16,4]{1,0} all-gather(%y), dimensions={0}
  %cp = u32[4]{0} collective-permute(%z)
  %a2a = bf16[2,2]{1,0} all-to-all(%w)
  %ars = bf16[8,128]{1,0} all-reduce-start(%x)
  %other = f32[9999]{0} add(%a, %b)
"""


def test_cell_skips_equal_reference():
    for a in ALIASES:
        for s in SHAPES:
            assert cell_status(get_config(a), SHAPES[s]) == jcell_status(jget_config(a),
                                                                         JSHAPES[s]), (a, s)
    ok, why = cell_status(get_config("hubert-xlarge"), SHAPES["decode_32k"])
    assert not ok and "encoder" in why
    ok, why = cell_status(get_config("qwen2.5-32b"), SHAPES["long_500k"])
    assert not ok and "sub-quadratic" in why


def test_runnable_cell_count():
    cells = runnable_cells(all_configs())
    assert len(cells) == len(jrunnable_cells(jall_configs())) == 31 == len(CELLS)


def test_parse_collectives_equals_reference():
    out = dryrun.parse_collectives(HLO)
    assert out == jdryrun.parse_collectives(HLO)
    assert out["all-reduce"] == {"count": 2, "bytes": 2 * 8 * 128 * 2}
    assert out["all-gather"]["count"] == out["collective-permute"]["count"] == 1
    assert out["all-to-all"]["count"] == 1
    for t in ("(f32[2,2], bf16[4])", "bf16[8,4096,7168]", "pred[]", "(s32[3], u8[5,5])"):
        assert dryrun._shape_bytes(t) == jdryrun._shape_bytes(t)
    assert dryrun._shape_bytes("(f32[2,2], bf16[4])") == 16 + 8


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_model_flops_estimate_equals_reference(cell):
    arch, shape = cell
    got = dryrun.model_flops_estimate(get_config(arch), SHAPES[shape])
    want = jdryrun.model_flops_estimate(jget_config(arch), JSHAPES[shape])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


def test_dsv3_active_params():
    est = dryrun.model_flops_estimate(get_config("deepseek-v3-671b"), SHAPES["train_4k"])
    assert 6.3e11 < est["n_params"] < 7.3e11
    assert 3.0e10 < est["n_active"] < 5.5e10     # ~37B active
    assert est["model_flops"] == 6.0 * est["n_active"] * est["tokens"]


def test_input_specs_shapes():
    cfg = get_config("qwen2-vl-7b")
    sp = specs.input_specs(cfg, SHAPES["train_4k"])
    assert sp["tokens"].shape == (256, 4096)
    assert sp["positions"].shape == (3, 256, 4096)
    assert specs.batch_logical_axes(cfg, SHAPES["train_4k"])["positions"][1] == "batch"
    dec = specs.input_specs(cfg, SHAPES["decode_32k"])
    assert dec["tokens"].shape == (128, 1) and dec["pos"].shape == ()


_JTREES: dict = {}


def _ref_bytes(arch, shape_name, mesh_name) -> int:
    """The per-device argument bytes that the reference's specs give the
    cell's step (its lower_cell's in_shardings)."""
    cfg, shape, mesh = jget_config(arch), JSHAPES[shape_name], JMESHES[mesh_name]
    rules = jsh.rules_for(cfg)
    key = (arch, shape_name)
    if key not in _JTREES:
        model = JModel(cfg)
        if shape.kind == "train":
            hp = jtrain.default_hparams_for(cfg)
            trees = [(jtrain.abstract_train_state(model, hp), jtrain.train_state_specs(model, hp))]
        else:
            trees = [(model.abstract(), model.specs())]
            if shape.kind == "decode":
                trees.append((model.abstract_cache(shape.global_batch, shape.seq_len),
                              model.cache_specs(shape.global_batch, shape.seq_len)))
        inp, ax = jspecs.input_specs(cfg, shape), jspecs.batch_logical_axes(cfg, shape)
        if shape.kind == "decode":
            trees.append(({"tokens": inp["tokens"]}, {"tokens": ax["tokens"]}))
        else:
            trees.append((inp, ax))
        _JTREES[key] = trees
    import jax
    total = 0
    for abstract, axes in _JTREES[key]:
        leaves = jax.tree.leaves(abstract)
        ax_leaves = jax.tree.leaves(axes, is_leaf=jsh.is_axes_leaf)
        for leaf, a in zip(leaves, ax_leaves, strict=True):
            spec = jsh.logical_to_spec(leaf.shape, a, mesh, rules, param_retry=True)
            n = math.prod(leaf.shape)
            for e in spec:
                for name in ((e,) if isinstance(e, str) else (e or ())):
                    n //= mesh.shape[name]
            total += n * np.dtype(leaf.dtype).itemsize
    if shape.kind == "decode":
        total += 4                                   # pos, an int32 scalar
    return total


@pytest.mark.parametrize("mesh_name", sorted(JMESHES))
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_argument_bytes_equal_reference_specs(cell, mesh_name):
    arch, shape = cell
    got = dryrun.cell_bytes(get_config(arch), SHAPES[shape], dryrun.PRODUCTION_MESHES[mesh_name])
    assert got["argument_bytes"] == _ref_bytes(arch, shape, mesh_name)


def test_all_runs_on_the_cpu_in_seconds(tmp_path):
    t0 = time.perf_counter()
    records = dryrun.main(["--all", "--out", str(tmp_path)])
    took = time.perf_counter() - t0
    assert took < 120, took
    assert len(records) == 2 * (len(CELLS) + 1)
    assert all(r["status"] == "ok" and r["temp_bytes"] is None for r in records)
    assert len(list(tmp_path.glob("*.json"))) == len(records)
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in records}
    # the zamba2-7b long_500k caches (97.8 GB in bf16) split over model, batch
    # 1 cannot split; the SSM conv caches of B and C (ssm_state) stay whole
    from repro_torch.models.model import Model
    z = by[("zamba2-7b", "long_500k", "pod16x16")]["memory"]
    whole = sum(math.prod(t.shape) * t.element_size() for _, t in leaf_paths(
        Model(get_config("zamba2-7b"), device="meta").abstract_cache(1, 524288)))
    assert whole == 97_788_369_664 and z["cache_bytes"] == 6_111_831_424
    assert 0 < z["cache_bytes"] * 16 - whole < 1e-4 * whole
    # every train cell gathers and reduce-scatters; MoE cells move tokens
    for (arch, shape, _), r in by.items():
        if shape == "train_4k":
            assert r["collectives"]["all-gather"]["count"] > 0
            assert r["collectives"]["reduce-scatter"]["count"] > 0
        if arch.startswith("deepseek") and shape != "long_500k":
            assert r["collectives"]["all-to-all"]["count"] > 0


@pytest.mark.parametrize("mesh_name", sorted(dryrun.PRODUCTION_MESHES))
@pytest.mark.parametrize("arch", ["qwen2.5-32b", "minitron-4b", "qwen2-vl-7b"])
def test_q_sequence_case_on_production_meshes(monkeypatch, arch, mesh_name):
    """Heads that split over ``model`` neither by KV head nor by q group:
    every rank holds whole attention weights (q's and K/V's gradients
    partial over ``model``, ``wo`` alike on every rank) and gathers its
    query rows' output before ``wo``: once a layer in a prefill (per
    Q_CHUNK block's rows above the threshold, all in one gather); twice
    in a train step's forward and recompute (f's all-reduce of x's gradient
    in backward takes the place of g's in forward), none in a decode
    step."""
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.train import default_hparams_for
    from repro_torch.models import layers
    cfg, mesh = get_config(arch), dryrun.PRODUCTION_MESHES[mesh_name]
    rules = sh.rules_for(cfg)
    assert layers.attn_mode(mesh, rules, cfg.n_heads, cfg.n_kv_heads) == "qseq"
    assert sh.tp_ways(mesh, rules, "heads", cfg.n_heads) == 1
    keys = ("wq", "wk", "wv", "wo") + (("bq", "bk", "bv") if cfg.qkv_bias else ())
    roles = {k: fsdp.leaf_role(cfg, mesh, rules, f"blocks.0.attn.{k}") for k in keys}
    assert roles == {k: None if k == "wo" else "partial" for k in keys}
    o = cfg.n_heads * cfg.head_dim * 2          # a row of the output in bf16
    hp = default_hparams_for(cfg)
    with monkeypatch.context() as mp:
        mp.setattr(dryrun, "_qseq_parts", lambda *a: ([], []))
        base = [dryrun.train_collectives(cfg, hp, mesh, 256, 4096),
                dryrun.serve_collectives(cfg, mesh, 32, 32768),
                dryrun.serve_collectives(cfg, mesh, 128, 1, 32768)]
    got = [dryrun.train_collectives(cfg, hp, mesh, 256, 4096),
           dryrun.serve_collectives(cfg, mesh, 32, 32768),
           dryrun.serve_collectives(cfg, mesh, 128, 1, 32768)]
    mb = 256 // hp.grad_accum
    rows = [mb // dryrun._n_batch(mesh, rules, mb, 4096), 32 // dryrun._n_batch(mesh, rules, 32,
                                                                                 32768)]
    want = [(cfg.n_layers * hp.grad_accum * 2, rows[0] * 4096 * o),
            (cfg.n_layers, rows[1] * 32768 * o), (0, 0)]
    for g, b, (n, nbytes) in zip(got, base, want):
        assert g["all-gather"]["count"] - b["all-gather"]["count"] == n
        assert g["all-gather"]["bytes"] - b["all-gather"]["bytes"] == n * nbytes
        assert g["all-reduce"] == b["all-reduce"]


@pytest.mark.parametrize("mesh_name", sorted(dryrun.PRODUCTION_MESHES))
def test_sp_activations_on_production_meshes(mesh_name):
    """deepseek-v3-671b's Megatron-SP carry: per microbatch, one cut at the
    run's start and one gather at its end, and each of its 61 entries'
    gather in forward and recompute and its cut's gradient gather, every
    one of the whole carry's bytes; nothing without the flag."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.train import default_hparams_for
    cfg, mesh = get_config("deepseek-v3-671b"), dryrun.PRODUCTION_MESHES[mesh_name]
    hp = default_hparams_for(cfg)
    with_sp = dryrun.train_collectives(cfg, hp, mesh, 256, 4096)
    without = dryrun.train_collectives(cfg.with_overrides(sp_activations=False), hp, mesh,
                                       256, 4096)
    mb = 256 // hp.grad_accum
    x = mb // dryrun._n_batch(mesh, sh.rules_for(cfg), mb, 4096) * 4096 * cfg.d_model * 2
    times = hp.grad_accum * (2 + 3 * cfg.n_layers)
    assert with_sp["all-gather"]["count"] - without["all-gather"]["count"] == times
    assert with_sp["all-gather"]["bytes"] - without["all-gather"]["bytes"] == times * x
    for kind in ("all-reduce", "reduce-scatter", "all-to-all"):
        assert with_sp[kind] == without[kind], kind
    assert dryrun.serve_collectives(cfg, mesh, 32, 32768) == dryrun.serve_collectives(
        cfg.with_overrides(sp_activations=False), mesh, 32, 32768)
