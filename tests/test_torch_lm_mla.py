"""The port's Multi-head Latent Attention (repro_torch.models.mla) against
repro's on the same numpy inputs and weights: the expanded prefill and the
absorbed decode step, without and with the q latent (deepseek-v2-lite's
and deepseek-v3's branches), in f32 at the reference's atol=1e-5
(tests/models/test_attention.py) scaled by the largest magnitude where
that exceeds 1; the cache row written in place; and the port's absorbed
decode equal to its own expanded prefill at the reference's atol=2e-4
(test_mla_absorbed_equals_expanded)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as jblocks
from repro.models import mla as jmla
from repro.models.config import ModelConfig as JConfig
from repro_torch.models import blocks, mla
from repro_torch.models.decode import pad_seq
from repro_torch.models.config import ModelConfig

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ATOL = 1e-5
B, S, CAP = 2, 6, 9


def _cfgs(q_lora: int, **kw):
    base = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
                head_dim=12, d_ff=64, vocab_size=64, attn_type="mla",
                q_lora_rank=q_lora, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=4,
                v_head_dim=8, param_dtype="float32", compute_dtype="float32",
                remat="none")
    base.update(kw)
    return JConfig(**base), ModelConfig(**base)


def np_params(defs, rng):
    """Numpy weights for a reference PSpec tree, by the reference's rule
    (normal with std ``scale`` or 1/sqrt(shape[-2]); ones; zeros)."""
    if isinstance(defs, dict):
        return {k: np_params(v, rng) for k, v in defs.items()}
    if defs.init != "normal":
        return (np.ones if defs.init == "ones" else np.zeros)(defs.shape, np.float32)
    fan_in = defs.shape[-2] if len(defs.shape) >= 2 else defs.shape[-1]
    std = defs.scale if defs.scale is not None else fan_in ** -0.5
    return (std * rng.standard_normal(defs.shape)).astype(np.float32)


def both(tree):
    """A numpy tree as a jax tree and a torch tree."""
    if isinstance(tree, dict):
        pairs = {k: both(v) for k, v in tree.items()}
        return ({k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(np.array(tree))


def _setup(q_lora: int, seed: int = 0, **kw):
    """(reference cfg, port cfg, reference params, the same as tensors,
    x as jax and torch, positions as jax and torch)."""
    jcfg, cfg = _cfgs(q_lora, **kw)
    rng = np.random.default_rng(seed)
    jp, tp = both(np_params(jmla.mla_defs(jcfg), rng))
    jx, tx = both((0.5 * rng.standard_normal((B, S, 32))).astype(np.float32))
    jpos, tpos = both(np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)))
    return jcfg, cfg, jp, tp, jx, tx, jpos, tpos


# the reference's functions compiled whole: one compile per configuration
# costs less than its primitives dispatched one by one
_ref_attention = jax.jit(jmla.mla_attention, static_argnums=(2,))
_ref_decode = jax.jit(jmla.mla_decode, static_argnums=(2,))


def _close(got, ref, atol=ATOL):
    ref = np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0,
                               atol=atol * max(1.0, float(np.abs(ref).max())))


def test_mla_defs_equal_reference():
    for q_lora in (0, 32):
        jcfg, cfg = _cfgs(q_lora)
        want = jmla.mla_defs(jcfg)
        got = mla.mla_defs(cfg)
        assert list(got) == list(want)
        assert [(p.shape, p.axes, p.init, p.scale) for p in got.values()] == \
            [(p.shape, p.axes, p.init, p.scale) for p in want.values()]
        cache = mla.mla_cache_defs(cfg, B, CAP)
        assert {k: p.shape for k, p in cache.items()} == \
            {k: p.shape for k, p in jmla.mla_cache_defs(jcfg, B, CAP).items()}


@pytest.mark.parametrize("q_lora", [0, 32])
def test_mla_prefill_matches_reference(q_lora):
    jcfg, cfg, jp, tp, jx, tx, jpos, tpos = _setup(q_lora)
    want, (jc, jr) = _ref_attention(jx, jp, jcfg, jpos)
    got, (c_kv, k_rope) = mla.mla_attention(tx, tp, cfg, tpos)
    assert got.shape == (B, S, 32) and c_kv.shape == (B, S, 16) and k_rope.shape == (B, S, 4)
    _close(got, want)
    _close(c_kv, jc)
    _close(k_rope, jr)


@pytest.mark.parametrize("q_lora", [0, 32])
def test_mla_absorbed_decode_matches_reference(q_lora):
    jcfg, cfg, jp, tp, jx, tx, jpos, tpos = _setup(q_lora, seed=3)
    _, (jc, jr) = _ref_attention(jx, jp, jcfg, jpos)
    pad = ((0, 0), (0, CAP - (S - 1)), (0, 0))
    jcache = {"c_kv": jnp.pad(jc[:, :S - 1], pad), "k_rope": jnp.pad(jr[:, :S - 1], pad)}
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    want, jnew = _ref_decode(jx[:, S - 1:], jp, jcfg, jcache, jnp.int32(S - 1))
    got, new = mla.mla_decode(tx[:, S - 1:], tp, cfg, cache, S - 1)
    assert got.shape == (B, 1, 32)
    _close(got, want)
    for k in ("c_kv", "k_rope"):
        _close(new[k], jnew[k])


def test_mla_decode_writes_the_cache_row_in_place():
    _, cfg, _, tp, _, tx, _, tpos = _setup(0, seed=5)
    _, (c_kv, k_rope) = mla.mla_attention(tx, tp, cfg, tpos)
    cache = {"c_kv": pad_seq(c_kv[:, :3], CAP), "k_rope": pad_seq(k_rope[:, :3], CAP)}
    assert cache["c_kv"].shape == (B, CAP, 16) and not cache["c_kv"][:, 3:].any()
    before = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    _, out = mla.mla_decode(tx[:, 3:4], tp, cfg, cache, 3)
    assert out is cache and {k: v.data_ptr() for k, v in cache.items()} == ptrs
    rows = torch.arange(CAP) != 3
    for k, full in (("c_kv", c_kv), ("k_rope", k_rope)):
        assert torch.equal(cache[k][:, rows], before[k][:, rows])
        _close(cache[k][:, 3], full[:, 3].numpy())      # the prefill's row at 3


@pytest.mark.parametrize("q_lora", [0, 32])
def test_mla_absorbed_equals_expanded(q_lora):
    """The port alone: decoding the last token against the cache of the
    first S - 1 equals the expanded prefill's last row."""
    _, cfg, _, tp, _, tx, _, tpos = _setup(q_lora, seed=7)
    out, (c_kv, k_rope) = mla.mla_attention(tx, tp, cfg, tpos)
    cache = {"c_kv": pad_seq(c_kv[:, :S - 1], CAP), "k_rope": pad_seq(k_rope[:, :S - 1], CAP)}
    dec, _ = mla.mla_decode(tx[:, S - 1:], tp, cfg, cache, S - 1)
    np.testing.assert_allclose(dec[:, 0].numpy(), out[:, S - 1].numpy(), atol=2e-4)


def test_mla_bf16_matches_reference():
    """bf16 compute on f32 weights: the reference's casts, each mirrored,
    leave the prefill and the absorbed step within two bf16 ulps of the
    output's magnitude."""
    jcfg, cfg, jp, tp, jx, tx, jpos, tpos = _setup(32, seed=9, compute_dtype="bfloat16")
    jxb, txb = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want, (jc, jr) = _ref_attention(jxb, jp, jcfg, jpos)
    got, (c_kv, _) = mla.mla_attention(txb, tp, cfg, tpos)
    assert got.dtype == torch.bfloat16 and c_kv.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), atol=2 * 2.0 ** -8)
    pad = ((0, 0), (0, CAP - (S - 1)), (0, 0))
    jcache = {"c_kv": jnp.pad(jc[:, :S - 1], pad), "k_rope": jnp.pad(jr[:, :S - 1], pad)}
    cache = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(torch.bfloat16)
             for k, v in jcache.items()}
    want, _ = _ref_decode(jxb[:, S - 1:], jp, jcfg, jcache, jnp.int32(S - 1))
    got, _ = mla.mla_decode(txb[:, S - 1:], tp, cfg, cache, S - 1)
    _close(got, np.asarray(want.astype(jnp.float32)), atol=2 * 2.0 ** -8)


@pytest.mark.parametrize("use_moe", [False, True])
def test_mla_block_prefill_and_decode_match_reference(use_moe):
    """A whole block (MLA, then the gated MLP or the MoE feed-forward): the
    prefill's output and padded {"c_kv", "k_rope"} cache, then one decode
    step, against repro.models.blocks."""
    jcfg, cfg = _cfgs(0, n_experts=4, top_k=2, moe_d_ff=8, n_shared_experts=1,
                      capacity_factor=2.0)
    rng = np.random.default_rng(11)
    jp, tp = both(np_params(jblocks.dense_block_defs(jcfg, use_moe=use_moe), rng))
    block = blocks.DenseBlock(cfg, tp, use_moe)
    jx, tx = both((0.5 * rng.standard_normal((B, S + 1, 32))).astype(np.float32))
    jpos, tpos = both(np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)))
    prefill = jax.jit(jblocks.dense_block_prefill, static_argnums=(2, 4, 5))
    jy, jcache = prefill(jx[:, :S], jp, jcfg, jpos, CAP, use_moe)
    y, cache = block.prefill(tx[:, :S], tpos, CAP)
    _close(y, jy)
    assert sorted(cache) == ["c_kv", "k_rope"] and cache["c_kv"].shape == (B, CAP, 16)
    for k in cache:
        _close(cache[k], jcache[k])
    decode = jax.jit(jblocks.dense_block_decode, static_argnums=(2, 5))
    jd, _ = decode(jx[:, S:], jp, jcfg, jcache, jnp.int32(S), use_moe)
    d, _ = block.decode(tx[:, S:], cache, S)
    _close(d, jd)


def _absorbed_vs_expanded(attention, decode, cfg, p, x, pos, pad_cache):
    """RMS of the absorbed step's output at the last position minus the
    expanded row there, over the RMS of that row."""
    s = x.shape[1]
    out, (c_kv, k_rope) = attention(x, p, cfg, pos)
    dec, _ = decode(x[:, s - 1:], p, cfg, pad_cache(c_kv[:, :s - 1], k_rope[:, :s - 1]), s - 1)
    a = np.asarray(out[:, s - 1], np.float32) if not isinstance(out, torch.Tensor) \
        else out[:, s - 1].float().numpy()
    b = np.asarray(dec[:, 0], np.float32) if not isinstance(dec, torch.Tensor) \
        else dec[:, 0].float().numpy()
    return float(np.sqrt(((a - b) ** 2).mean() / (a ** 2).mean()))


def test_absorbed_and_expanded_differ_in_bf16_as_the_reference():
    """At deepseek-v2-lite's MLA widths (d 2048, 16 heads, kv_lora 512) and
    the fan-in init, the unscaled scores reach ~1e3, where a bf16 ulp is
    4-8: the absorbed step (scores from q_nope . wk_b rounded, then . c_kv)
    and the expanded prefill (q_nope . (c_kv . wk_b) rounded) round them
    differently.  In the reference's own bf16 the two disagree by more than
    5e-3 RMS, in f32 by less than 1e-4; the port likewise, and its expanded
    bf16 output is the reference's within a bf16 ulp."""
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config
    s = 65
    rng = np.random.default_rng(21)
    base = dict(param_dtype="float32", n_layers=1)
    jfull, full = jget_config("deepseek_v2_lite_16b"), get_config("deepseek_v2_lite_16b")
    jp, tp = both(np_params(jmla.mla_defs(jfull), rng))
    jx, tx = both(rng.standard_normal((1, s, full.d_model)).astype(np.float32))
    jpos, tpos = both(np.arange(s, dtype=np.int32)[None])
    jpad = lambda c, r: {"c_kv": jnp.pad(c, ((0, 0), (0, 1), (0, 0))),
                         "k_rope": jnp.pad(r, ((0, 0), (0, 1), (0, 0)))}
    tpad = lambda c, r: {"c_kv": pad_seq(c, s), "k_rope": pad_seq(r, s)}
    ratios = {}
    for dt in ("bfloat16", "float32"):
        jcfg = jfull.with_overrides(compute_dtype=dt, **base)
        cfg = full.with_overrides(compute_dtype=dt, **base)
        ratios[dt] = (_absorbed_vs_expanded(_ref_attention, _ref_decode, jcfg, jp,
                                            jx.astype(jcfg.dtype("compute")), jpos, jpad),
                      _absorbed_vs_expanded(mla.mla_attention, mla.mla_decode, cfg, tp,
                                            tx.to(cfg.dtype("compute")), tpos, tpad))
    assert all(r > 5e-3 for r in ratios["bfloat16"]), ratios
    assert all(r < 1e-4 for r in ratios["float32"]), ratios
    cfg = full.with_overrides(compute_dtype="bfloat16", **base)
    jcfg = jfull.with_overrides(compute_dtype="bfloat16", **base)
    want, _ = _ref_attention(jx.astype(jnp.bfloat16), jp, jcfg, jpos)
    got, _ = mla.mla_attention(tx.to(torch.bfloat16), tp, cfg, tpos)
    _close(got, np.asarray(want.astype(jnp.float32)), atol=2.0 ** -8)
