"""The port's model (repro_torch.models.model) against repro's, with the
same weights in both: for every dense configuration, both DeepSeek (MLA
and MoE) configurations and the ssm (mamba2-130m) and hybrid (zamba2-7b)
ones under reduced(), forward logits, prefill logits and caches (mapped
onto the reference's cache tree, leaf by leaf), and three decode steps (those two in
test_torch_lm_model_decode.py), in f32 at the reference's
decode-consistency atol=2e-4 (tests/models/test_decode_consistency.py).

The weights are drawn once per configuration by the port's seeded init and
handed to the reference as its parameter tree (the reference's init of a
reduced model costs 1-18 s in a fresh process, most of it compiling each
leaf's draw); test_reference_init_carried_across holds
params_from_reference on the reference's own init, one configuration of
each family.  The reference's forward, prefill and decode step run under
jax.jit (one compile a program instead of one an operation); the bf16
case keeps the reference's eager init and forward, on which its bound was
set."""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models.config import count_params as jcount_params
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers
from repro_torch.models.config import count_params
from repro_torch.models.convert import params_from_reference, reference_params
from repro_torch.models.model import Model, param_defs

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ATOL = 2e-4
DECODABLE = ["stablelm_3b", "chatglm3_6b", "minitron_4b", "qwen2_5_32b", "qwen2_vl_7b"]
DENSE = DECODABLE + ["hubert_xlarge"]
MOE = ["deepseek_v2_lite_16b", "deepseek_v3_671b"]
SSM = ["mamba2_130m", "zamba2_7b"]
B, S, CAP = 2, 12, 16


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@functools.lru_cache(maxsize=None)
def _weights(arch, over=()):
    cfg = reduced(get_config(arch)).with_overrides(**dict(over))
    return jax.tree.map(_np, reference_params(Model(cfg, device="cpu", seed=0)))


def port_weights(arch, **over):
    """The reduced configuration's weights from the port's seeded init (seed
    0), as the reference's parameter tree of numpy arrays; drawn once per
    configuration and process."""
    return _weights(arch, tuple(sorted(over.items())))


def _pair(arch, **over):
    """(reference model, its params, port model holding the same weights)."""
    jcfg = jreduced(jget_config(arch)).with_overrides(**over)
    cfg = reduced(get_config(arch)).with_overrides(**over)
    weights = port_weights(arch, **over)
    params = jax.tree.map(jnp.asarray, weights)
    return JModel(jcfg), params, params_from_reference(weights, Model(cfg, device="cpu"))


def _batch(cfg, seed=1, seq=S):
    """The same inputs as a jax dict and a torch dict."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encoder":
        arrays = {"frames": rng.standard_normal((B, seq, cfg.frontend_dim)).astype(np.float32)}
    else:
        arrays = {"tokens": rng.integers(0, cfg.vocab_size, (B, seq), dtype=np.int32)}
    if cfg.family == "vlm":
        arrays["vision_embeds"] = rng.standard_normal((B, 3, cfg.frontend_dim)).astype(np.float32)
        arrays["positions"] = np.stack([np.broadcast_to(np.arange(seq, dtype=np.int32) + c,
                                                        (B, seq)) for c in range(3)])
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})


def _logits(t, cfg):
    return t.detach().float().numpy()[..., :cfg.vocab_size]


def _ref_logits(a, cfg):
    return np.asarray(a).astype(np.float32)[..., :cfg.vocab_size]


@pytest.mark.parametrize("arch", DENSE + MOE + SSM)
def test_forward_matches_reference(arch):
    jm, params, model = _pair(arch)
    jb, tb = _batch(model.cfg)
    got = model.forward(tb)
    assert got.shape == (B, S, model.cfg.vocab_padded)
    np.testing.assert_allclose(_logits(got, model.cfg),
                               _ref_logits(jax.jit(jm.forward)(params, jb), model.cfg), atol=ATOL)


# one configuration of each family: (family, arch)
FAMILIES = [("dense", "stablelm_3b"), ("vlm", "qwen2_vl_7b"), ("encoder", "hubert_xlarge"),
            ("moe", "deepseek_v3_671b"), ("ssm", "mamba2_130m"), ("hybrid", "zamba2_7b")]


@pytest.mark.parametrize("family,arch", FAMILIES, ids=[f for f, _ in FAMILIES])
def test_reference_init_carried_across(family, arch):
    """The reference's own init (jm.init, compiled whole by jax.jit: the
    same draws in one program, a third of the time of its eager operations
    one by one; its low bits differ from theirs) carried across by
    params_from_reference: every leaf bit for bit, and the port's forward
    logits the reference's within ATOL."""
    jcfg = jreduced(jget_config(arch))
    jm = JModel(jcfg)
    params = jax.jit(jm.init)(jax.random.key(0))
    weights = jax.tree.map(np.asarray, params)
    model = params_from_reference(weights, Model(reduced(get_config(arch)), device="cpu"))
    assert model.cfg.family == jcfg.family == family
    back = dict(_leaves(reference_params(model)))
    want = dict(_leaves(weights))
    assert back.keys() == want.keys()
    assert all(np.array_equal(back[k].detach().numpy(), want[k]) for k in want)
    jb, tb = _batch(model.cfg)
    np.testing.assert_allclose(_logits(model.forward(tb), model.cfg),
                               _ref_logits(jax.jit(jm.forward)(params, jb), model.cfg),
                               atol=ATOL)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


BF16_ATOL = 2 * 2.0 ** -8     # two bf16 ulps of a logit in [0.5, 1)


@functools.lru_cache(maxsize=None)
def _bf16_ref():
    """chatglm3-6b in bf16 compute from the reference's own init (the bound
    was set on these weights; on the port's seeded ones the two packages'
    logits lie up to 0.031 apart): the weights and the reference's logits,
    computed once."""
    over = dict(compute_dtype="bfloat16")
    jm = JModel(jreduced(jget_config("chatglm3_6b")).with_overrides(**over))
    params = jm.init(jax.random.key(0))
    cfg = reduced(get_config("chatglm3_6b")).with_overrides(**over)
    return (jax.tree.map(np.asarray, params),
            _ref_logits(jm.forward(params, _batch(cfg)[0]), cfg))


def _bf16_case():
    weights, ref = _bf16_ref()
    cfg = reduced(get_config("chatglm3_6b")).with_overrides(compute_dtype="bfloat16")
    model = params_from_reference(weights, Model(cfg, device="cpu"))
    _, tb = _batch(model.cfg)
    assert np.abs(ref).max() < 1.0
    return model, tb, ref


def test_bf16_compute_matches_reference():
    """bf16 compute, f32 storage (stablelm-3b's split) on chatglm3-6b's
    reduced shape (GQA, qkv bias, 2d RoPE): within two bf16 ulps of the
    logits' magnitude (|logit| < 1: 2 x 2^-8 = 0.0078)."""
    model, tb, ref = _bf16_case()
    got = model.forward(tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_logits(got, model.cfg), ref, atol=BF16_ATOL)


def test_bf16_tolerance_catches_a_missing_cast(monkeypatch):
    """The bf16 bound sees a cast dropped: rmsnorm's statistics taken in
    bf16 instead of f32 move the logits past it."""
    model, tb, ref = _bf16_case()

    def rmsnorm_without_f32(x, params, eps):
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        return x * torch.rsqrt(var + eps) * params["scale"].to(x.dtype)

    monkeypatch.setattr(layers, "rmsnorm", rmsnorm_without_f32)
    err = np.abs(_logits(model.forward(tb), model.cfg) - ref).max()
    assert err > 2 * BF16_ATOL, err


def test_bf16_cache_dtype_and_cast_copy():
    _, _, model = _pair("stablelm_3b", compute_dtype="bfloat16")
    _, tb = _batch(model.cfg)
    log, cache = model.prefill(tb, CAP)
    assert cache[0]["k"].dtype == torch.bfloat16 and log.dtype == torch.bfloat16
    fresh = model.init_cache(B, CAP)
    assert len(fresh) == model.cfg.n_layers and fresh[0]["v"].shape == (B, CAP, 4, 16)
    assert fresh[0]["v"].dtype == torch.bfloat16 and not fresh[0]["v"].any()
    copy = model.cast(torch.bfloat16)
    for (name, a), (name2, b) in zip(model.state_dict().items(), copy.state_dict().items()):
        assert name == name2 and b.dtype == torch.bfloat16
        assert torch.equal(a.to(torch.bfloat16), b)
    # the cast copy serves the same bits as the f32 weights cast at each use
    _, cache2 = copy.prefill(tb, CAP)
    tok = torch.tensor([[1], [2]], dtype=torch.int32)
    assert torch.equal(model.decode_step(cache, tok, S)[0], copy.decode_step(cache2, tok, S)[0])


FULL_COUNTS = {"stablelm_3b": 2_795_932_160, "deepseek_v2_lite_16b": 15_706_484_224,
               "deepseek_v3_671b": 671_712_662_528, "mamba2_130m": 129_057_216,
               "zamba2_7b": 6_750_539_856}


@pytest.mark.parametrize("arch", DENSE + MOE + SSM)
def test_count_params_equals_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert count_params(param_defs(cfg)) == jcount_params(JModel(jcfg).param_defs())
    if arch in FULL_COUNTS:
        assert count_params(param_defs(cfg)) == FULL_COUNTS[arch]
    if arch in MOE + SSM:  # the full configuration builds on meta, mtp leaves and all
        model = Model(cfg, device="meta")
        assert sum(p.numel() for p in model.parameters()) == FULL_COUNTS[arch]
        assert (model.mtp is not None) == bool(cfg.mtp_depth)


def test_seeded_init_follows_the_rule():
    cfg = reduced(get_config("chatglm3_6b"))
    a, b = Model(cfg, device="cpu", seed=3), Model(cfg, device="cpu", seed=3)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                   b.state_dict().values()))
    assert not torch.equal(Model(cfg, device="cpu", seed=4).embed["tok"], a.embed["tok"])
    blk = a.blocks[0]
    assert torch.equal(blk["ln1"]["scale"], torch.ones(cfg.d_model))
    assert not blk["attn"]["bq"].any()
    # std 0.02 for the embedding, 1/sqrt(shape[-2]) otherwise
    assert abs(float(a.embed["tok"].std()) - 0.02) < 0.002
    assert abs(float(blk["ffn"]["wd"].std()) - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    assert abs(float(blk["attn"]["wq"].std()) - cfg.n_heads ** -0.5) < 0.1 * cfg.n_heads ** -0.5
    # trainable (the training slice); serving records no graph
    assert all(p.requires_grad for p in a.parameters())


def test_hybrid_holds_the_shared_block_once():
    """zamba2-7b's shared block: one set of weights in the state dict, run
    after every E Mamba-2 blocks; the reference's tree loads strictly."""
    jm, params, model = _pair("zamba2_7b")
    cfg = model.cfg
    assert (cfg.n_layers, cfg.shared_attn_every) == (5, 2)
    keys = list(model.state_dict())
    shared = [k for k in keys if k.startswith("shared_attn.")]
    assert shared and not any(".shared_attn." in k for k in keys)
    assert len(shared) == len(_flat(params["shared_attn"]))
    assert sum(p.numel() for p in model.parameters()) == count_params(param_defs(cfg))
    assert [type(m).__name__ for m in model.plan] == (
        ["SSMBlock"] * 2 + ["DenseBlock"] + ["SSMBlock"] * 2 + ["DenseBlock", "SSMBlock"])
    assert model.plan[2] is model.plan[5] is model.shared_attn
    assert model.cache_slots == (("groups", 0), ("groups", 1), ("shared_attn", 0),
                                   ("groups", 2), ("groups", 3), ("shared_attn", 1),
                                   ("tail", 0))
    tree = jax.tree.map(np.asarray, params)
    want = tree["shared_attn"]["attn"]["wq"]
    assert np.array_equal(model.shared_attn["attn"]["wq"].detach().numpy(), want)
    assert np.array_equal(model.blocks[4]["mixer"]["wx"].detach().numpy(),
                          tree["stages"]["tail"]["mixer"]["wx"][0])
    del tree["shared_attn"]["ln2"]
    with pytest.raises(RuntimeError, match="shared_attn.ln2.scale"):
        params_from_reference(tree, Model(cfg, device="cpu"))
    # zero caches in the plan's layout; the reference's tree from them
    fresh = model.init_cache(B, CAP)
    assert len(fresh) == 7 and fresh[2]["k"].shape == (B, CAP, 4, 16)
    assert fresh[0]["state"].shape == (B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    ref = model.reference_cache(fresh)
    assert ref["shared_attn"]["v"].shape == (2, B, CAP, 4, 16)
    assert ref["stages"]["groups"]["conv_x"].shape == (4, B, 3, cfg.ssm_d_inner)
    assert ref["stages"]["tail"]["state"].shape[0] == 1
    with pytest.raises(ValueError, match="6 caches for a plan of 7"):
        model.reference_cache(fresh[:6])


def _flat(tree):
    return [leaf for _, leaf in _leaves(tree)]


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(reduced(get_config("stablelm_3b")))


def test_padding_logits_masked():
    _, _, model = _pair("stablelm_3b", vocab_size=300)
    _, tb = _batch(model.cfg)
    log, _ = model.prefill(tb, CAP)
    assert log.shape == (B, 512) and bool((log[:, 300:] == -1e30).all())


def test_bf16_tree_carried_bit_for_bit():
    jcfg = jreduced(jget_config("chatglm3_6b")).with_overrides(param_dtype="bfloat16")
    cfg = reduced(get_config("chatglm3_6b")).with_overrides(param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.key(0)))
    model = params_from_reference(tree, Model(cfg, device="cpu"))
    got = model.blocks[1]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    want = tree["stages"]["layers"]["attn"]["wq"][1].astype(np.float32)
    assert np.array_equal(got.detach().float().numpy(), want)
    del tree["final_norm"]
    with pytest.raises(RuntimeError, match="final_norm.scale"):
        params_from_reference(tree, Model(cfg, device="cpu"))
    tree = jax.tree.map(_np, reference_params(Model(cfg.with_overrides(n_layers=3),
                                                    device="cpu")))
    with pytest.raises(ValueError, match="3 layers, the model has 4"):
        params_from_reference(tree, Model(cfg, device="cpu"))
