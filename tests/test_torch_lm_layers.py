"""The port's transformer layers (repro_torch.models.layers, .decode) against
repro's on the same numpy inputs and weights, in f32 at the reference's own
atol=1e-5 (tests/models/test_attention.py), scaled by the largest magnitude
of the reference's output where that exceeds 1 (projections with the
reference's fan-in init reach |x| ~ 20, where one f32 ulp is 2e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode as jdecode
from repro.models import layers as jlayers
from repro.models.config import ModelConfig as JConfig
from repro.models.config import init_params as jinit
from repro_torch.models import decode, layers
from repro_torch.models.config import ModelConfig

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ATOL = 1e-5


def _cfgs(**kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4,
                n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
                param_dtype="float32", compute_dtype="float32", remat="none")
    base.update(kw)
    return JConfig(**base), ModelConfig(**base)


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _params(defs, seed=0):
    """The reference's initialised tree, as jax and as torch leaves."""
    jp = jinit(defs, jax.random.key(seed), jnp.float32)
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def _close(port, ref, atol=ATOL):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port.detach().numpy(), ref, rtol=0, atol=atol * scale)


def test_rmsnorm():
    rng = np.random.default_rng(0)
    xj, xt = _both(_normal(rng, (2, 5, 32), 3.0))
    scale = _normal(rng, (32,))
    _close(layers.rmsnorm(xt, {"scale": torch.from_numpy(scale)}, 1e-5),
           jlayers.rmsnorm(xj, {"scale": jnp.asarray(scale)}, 1e-5))


@pytest.mark.parametrize("style,hd", [("standard", 16), ("2d", 16), ("mrope", 32)])
def test_rope_styles(style, hd):
    jcfg, cfg = _cfgs(rope_style=style, head_dim=hd, rope_theta=1e6)
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    if style == "mrope":                 # (3, B, S): t / h / w components
        pos = rng.integers(0, 4096, (3, 2, 7)).astype(np.int32)
    pj, pt = _both(pos)
    aj, at = jlayers.rope_for(jcfg, pj), layers.rope_for(cfg, pt)
    assert at.shape == aj.shape
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6)
    xj, xt = _both(_normal(rng, (2, 7, 3, hd)))
    _close(layers.apply_rope(xt, at), jlayers.apply_rope(xj, aj))
    if style == "2d":                    # chatglm: the second half is left alone
        assert torch.equal(layers.apply_rope(xt, at)[..., hd // 2:], xt[..., hd // 2:])
    if style == "mrope":                 # text only: one position for t / h / w
        pj2, pt2 = _both(pos[0])
        np.testing.assert_allclose(layers.rope_for(cfg, pt2).numpy(),
                                   np.asarray(jlayers.rope_for(jcfg, pj2)), rtol=1e-6)


def test_embed_and_lm_head_mask_padding():
    jcfg, cfg = _cfgs(vocab_size=300)            # padded to 512
    jp, tp = _params(jlayers.embed_defs(jcfg))
    jh, th = _params(jlayers.head_defs(jcfg), seed=1)
    rng = np.random.default_rng(2)
    tj, tt = _both(rng.integers(0, 300, (2, 6)).astype(np.int32))
    _close(layers.embed(tt, tp, cfg), jlayers.embed(tj, jp, jcfg))
    xj, xt = _both(_normal(rng, (2, 6, 32)))
    got, want = layers.lm_head(xt, th, tp, cfg), jlayers.lm_head(xj, jh, jp, jcfg)
    assert got.shape == (2, 6, 512)
    _close(got[..., :300], want[..., :300])
    assert bool((got[..., 300:] == -1e30).all())


def test_tied_lm_head():
    jcfg, cfg = _cfgs(tie_embeddings=True)
    jp, tp = _params(jlayers.embed_defs(jcfg))
    xj, xt = _both(_normal(np.random.default_rng(3), (1, 4, 32)))
    _close(layers.lm_head(xt, {}, tp, cfg), jlayers.lm_head(xj, {}, jp, jcfg))


@pytest.mark.parametrize("bias,style", [(False, "standard"), (True, "2d")])
def test_attention_and_mlp(bias, style):
    jcfg, cfg = _cfgs(qkv_bias=bias, rope_style=style)
    jp, tp = _params(jlayers.attn_defs(jcfg))
    if bias:                                     # zeros at init: make them count
        rng = np.random.default_rng(4)
        for k in ("bq", "bk", "bv"):
            b = _normal(rng, tp[k].shape)
            jp[k], tp[k] = _both(b)
    rng = np.random.default_rng(5)
    xj, xt = _both(_normal(rng, (2, 9, 32)))
    pj, pt = _both(np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy())
    for got, want in zip(layers.qkv_proj(xt, tp, cfg, pt), jlayers.qkv_proj(xj, jp, jcfg, pj)):
        _close(got, want)
    _close(layers.attention(xt, tp, cfg, pt), jlayers.attention(xj, jp, jcfg, pj))
    mj, mt = _params(jlayers.mlp_defs(jcfg), seed=2)
    _close(layers.mlp(xt, mt, cfg), jlayers.mlp(xj, mj, jcfg))


def _qkv(seed, s=32, h=4, kv=2, d=8):
    rng = np.random.default_rng(seed)
    return [_both(_normal(rng, (2, s, n, d))) for n in (h, kv, kv)]


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_matches_reference(causal):
    jcfg, cfg = _cfgs()
    (qj, qt), (kj, kt), (vj, vt) = _qkv(6)
    _close(layers.sdpa(qt, kt, vt, cfg, causal=causal),
           jlayers.sdpa(qj, kj, vj, jcfg, causal=causal))


@pytest.mark.parametrize("s", [32, 29])          # whole blocks, and a ragged tail
def test_chunked_equals_full(monkeypatch, s):
    jcfg, cfg = _cfgs()
    (qj, qt), (kj, kt), (vj, vt) = _qkv(7, s=s)
    full = layers.sdpa(qt, kt, vt, cfg, causal=True)
    ref_full = jlayers.sdpa(qj, kj, vj, jcfg, causal=True)
    for mod in (layers, jlayers):
        monkeypatch.setattr(mod, "Q_CHUNK_THRESHOLD", 16)
        monkeypatch.setattr(mod, "Q_CHUNK", 8)
    chunked = layers.sdpa(qt, kt, vt, cfg, causal=True)
    _close(chunked, full)
    _close(chunked, jlayers.sdpa(qj, kj, vj, jcfg, causal=True))
    _close(chunked, ref_full)


def test_chunk_threshold_from_config():
    _, cfg = _cfgs(attn_q_chunk_threshold=8)
    (_, qt), (_, kt), (_, vt) = _qkv(8, s=20)
    _, full_cfg = _cfgs()
    _close(layers.sdpa(qt, kt, vt, cfg, causal=True),
           layers.sdpa(qt, kt, vt, full_cfg, causal=True))


def test_gqa_equals_repeated_kv():
    jcfg, cfg = _cfgs()
    (qj, qt), (kj, kt), (vj, vt) = _qkv(9, s=8)
    out = layers.sdpa(qt, kt, vt, cfg, causal=True)
    _close(out, jlayers.sdpa(qj, kj, vj, jcfg, causal=True))
    # query head h reads kv head h // 2
    _, cfg4 = _cfgs(n_kv_heads=4)
    ref = layers.sdpa(qt, kt.repeat_interleave(2, dim=2), vt.repeat_interleave(2, dim=2),
                      cfg4, causal=True)
    _close(out, ref)


def test_causal_mask():
    """Changing future keys never changes past outputs."""
    _, cfg = _cfgs()
    (_, qt), (_, kt), (_, vt) = _qkv(10, s=8)
    out1 = layers.sdpa(qt, kt, vt, cfg, causal=True)
    k2, v2 = kt.clone(), vt.clone()
    k2[:, 5:], v2[:, 5:] = 99.0, -99.0
    _close(layers.sdpa(qt, k2, v2, cfg, causal=True)[:, :5], out1[:, :5])


@pytest.mark.parametrize("bias", [False, True])
def test_gqa_decode_and_cache(bias):
    jcfg, cfg = _cfgs(qkv_bias=bias, rope_style="2d" if bias else "standard")
    jp, tp = _params(jlayers.attn_defs(jcfg))
    rng = np.random.default_rng(11)
    kc, vc = _normal(rng, (2, 12, 2, 8)), _normal(rng, (2, 12, 2, 8))
    jcache = {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    xj, xt = _both(_normal(rng, (2, 1, 32)))
    want, jnew = jdecode.gqa_decode(xj, jp, jcfg, jcache, jnp.int32(7))
    got, new = decode.gqa_decode(xt, tp, cfg, cache, 7)
    _close(got, want)
    assert new is cache                          # updated in place
    for k in ("k", "v"):
        _close(new[k], jnew[k])
    (pkj, pk), (pvj, pv) = _both(_normal(rng, (2, 5, 2, 8))), _both(_normal(rng, (2, 5, 2, 8)))
    padded = decode.prefill_kv(pk, pv, 12)
    ref = jdecode.prefill_kv(pkj, pvj, 12)
    for k in ("k", "v"):
        assert padded[k].shape == (2, 12, 2, 8)
        _close(padded[k], ref[k], atol=0)


def test_silu_follows_the_reference_in_bf16():
    """XLA evaluates jax.nn.silu in bf16 as x * 1 / (1 + exp(-x)), rounding
    at each step; the port writes the same steps (F.silu rounds once and
    differs from it in about a quarter of the outputs)."""
    x = _normal(np.random.default_rng(12), (200_000,), 4.0)
    ref = np.asarray(jax.nn.silu(jnp.asarray(x, jnp.bfloat16))).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    port = layers._silu(xt).float().numpy()
    assert (port != ref).mean() < 1e-3
    assert (torch.nn.functional.silu(xt).float().numpy() != ref).mean() > 0.1
    _close(layers._silu(torch.from_numpy(x)), jax.nn.silu(jnp.asarray(x)))
