"""The port's serving launcher (repro_torch.launch.serve, .specs) and its
configuration registry (repro_torch.configs) against repro's: greedy tokens
equal on the same weights (the port's seeded init, handed to the
reference's Server as its parameter tree), batches bit-equal,
configurations field by field."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.launch import serve as jserve
from repro.launch import specs as jspecs
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.launch import serve, specs
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import Model
from test_torch_lm_model import port_weights
from test_torch_lm_train import bounded_main

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", sorted(configs.ALIASES))
def test_configs_equal_reference(name):
    cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(configs.reduced(cfg)) == dataclasses.asdict(jconfigs.reduced(jcfg))
    assert cfg.vocab_padded == jcfg.vocab_padded
    assert configs.get_config(configs.ALIASES[name]) == cfg
    assert [shapes.cell_status(cfg, s) for s in shapes.SHAPES.values()] == \
        [jshapes.cell_status(jcfg, s) for s in jshapes.SHAPES.values()]


def test_registry_lists_and_refuses_as_reference():
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert shapes.runnable_cells(configs.all_configs()) == \
        jshapes.runnable_cells(jconfigs.all_configs())
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


@pytest.mark.parametrize("arch", ["stablelm_3b", "qwen2_vl_7b", "hubert_xlarge"])
@pytest.mark.parametrize("train", [False, True])
def test_concrete_batch_bit_equal(arch, train):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    got = specs.concrete_batch(cfg, 2, 16, train=train, seed=5, device="cpu")
    want = jspecs.concrete_batch(jcfg, 2, 16, train=train, seed=5)
    assert list(got) == list(want)
    for k, v in want.items():
        ref = np.asarray(v)
        assert str(got[k].dtype).removeprefix("torch.") == str(ref.dtype)
        a = got[k].float().numpy() if got[k].dtype == torch.bfloat16 else got[k].numpy()
        b = ref.astype(np.float32) if ref.dtype.name == "bfloat16" else ref
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("shape", sorted(shapes.SHAPES))
def test_input_specs_and_axes_equal_reference(shape):
    for arch in ("chatglm3_6b", "qwen2_vl_7b", "hubert_xlarge"):
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        got = specs.input_specs(cfg, shapes.SHAPES[shape])
        want = jspecs.input_specs(jcfg, jshapes.SHAPES[shape])
        assert list(got) == list(want)
        for k in want:
            assert got[k].shape == want[k].shape
            assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)
        assert specs.batch_logical_axes(cfg, shapes.SHAPES[shape]) == \
            jspecs.batch_logical_axes(jcfg, jshapes.SHAPES[shape])


@pytest.mark.parametrize("arch", ["stablelm_3b", "chatglm3_6b", "deepseek_v2_lite_16b",
                                  "mamba2_130m", "zamba2_7b"])
def test_greedy_tokens_equal_reference(arch):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    cfg = configs.reduced(configs.get_config(arch))
    weights = port_weights(arch)
    jsrv = jserve.Server(jcfg, params=jax.tree.map(jnp.asarray, weights))
    model = params_from_reference(weights, Model(cfg, device="cpu"))
    srv = serve.Server(cfg, model, device="cpu")
    batch = specs.concrete_batch(cfg, 2, 16, train=False, device="cpu")
    want = np.asarray(jsrv.generate(jspecs.concrete_batch(jcfg, 2, 16, train=False), 12,
                                    seq_cap=28))
    got = srv.generate(batch, 12, seq_cap=28)
    assert got.dtype == torch.int32 and got.shape == (2, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    # a fresh cache for each call: a second call gives the same tokens
    assert torch.equal(srv.generate(batch, 12, seq_cap=28), got)


def test_temperature_sampling_is_seeded():
    cfg = configs.reduced(configs.get_config("stablelm_3b"))
    srv = serve.Server(cfg, device="cpu", seed=1)
    batch = specs.concrete_batch(cfg, 2, 8, train=False, device="cpu")
    a = srv.generate(batch, 6, seq_cap=14, temperature=0.8, seed=3)
    assert torch.equal(a, srv.generate(batch, 6, seq_cap=14, temperature=0.8, seed=3))
    assert not torch.equal(a, srv.generate(batch, 6, seq_cap=14, temperature=0.8, seed=4))
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


def test_server_keeps_a_compute_copy():
    cfg = configs.reduced(configs.get_config("stablelm_3b")).with_overrides(
        compute_dtype="bfloat16")
    srv = serve.Server(cfg, device="cpu")
    assert srv.model.embed["tok"].dtype == torch.float32
    assert all(p.dtype == torch.bfloat16 for p in srv.compute.parameters())
    f32 = serve.Server(configs.reduced(configs.get_config("stablelm_3b")), device="cpu")
    assert f32.compute is f32.model


def test_server_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = configs.reduced(configs.get_config("stablelm_3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.Server(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        specs.concrete_batch(cfg, 1, 4, train=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])


def test_cli_reduced_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
                          "--device", "cpu", "--arch", "chatglm3-6b"],
                         capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "generated (2, 16)" in out.stdout and "on cpu" in out.stdout
    enc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
                          "--device", "cpu", "--arch", "hubert-xlarge"],
                         capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert enc.returncode != 0 and "encoder-only" in enc.stderr


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_cli_serves_ssm_configs_on_cpu(arch, capsys):
    """The launcher's entry, in process, on the reduced ssm and hybrid
    configurations."""
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "on cpu" in out


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v3-671b"])
def test_cli_serves_moe_configs_on_cpu(arch, capsys):
    """The launcher's entry, in process, on the reduced MLA and MoE
    configurations (q-lora and the mtp subtree with v3)."""
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "on cpu" in out


def test_cli_serves_on_a_mesh_of_two_ranks(tmp_path):
    """``--mesh --ranks 2`` serves the MoE configuration on (data, model) =
    (1, 2), its routed experts sharded over both ranks; the greedy tokens
    are one device's.  The mesh run is a child process with a time limit
    (test_torch_lm_train.bounded_main)."""
    argv = ["--arch", "deepseek-v2-lite-16b", "--reduced", "--device", "cpu",
            "--new-tokens", "4"]
    want = serve.main(argv)
    got = bounded_main("repro_torch.launch.serve", argv + ["--mesh", "--ranks", "2"], tmp_path)
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_generate_prompt_length_from_vlm_batch():
    arch = "qwen2_vl_7b"
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    cfg = configs.reduced(configs.get_config(arch))
    weights = port_weights(arch)
    jsrv = jserve.Server(jcfg, params=jax.tree.map(jnp.asarray, weights))
    model = params_from_reference(weights, Model(cfg, device="cpu"))
    srv = serve.Server(cfg, model, device="cpu")
    want = jsrv.generate(jspecs.concrete_batch(jcfg, 2, 16, train=False), 4, seq_cap=20)
    got = srv.generate(specs.concrete_batch(cfg, 2, 16, train=False, device="cpu"), 4,
                       seq_cap=20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
