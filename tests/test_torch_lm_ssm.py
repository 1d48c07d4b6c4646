"""The port's Mamba-2 block (repro_torch.models.ssm and the SSM block of
repro_torch.models.blocks) against repro's on the same numpy inputs and
weights.  Tolerances: the causal convolution within 1e-6 in f32 and bit
for bit in bf16; the chunked SSD scan at repro's own atol=2e-4
(tests/models/test_ssm.py), against repro and against a float64 numpy
recurrence; the block's forward, prefill cache and decode steps in f32 at
1e-5 of the largest magnitude (repro's attention atol, as
test_torch_lm_mla.py), and in bf16 within two bf16 ulps of the largest
magnitude (the gate's rmsnorm: XLA fuses its multiplies under jit, the
port rounds between them as layers.rmsnorm does), the caches within one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import blocks as jblocks
from repro.models import ssm as jssm
from repro_torch.configs import get_config, reduced
from repro_torch.models import blocks, ssm

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ATOL = 1e-5
SSD_ATOL = 2e-4
B, L = 2, 13          # 13: not a multiple of the reduced chunk (8)

_ref_conv = jax.jit(jssm._causal_conv)
_ref_ssd = jax.jit(jssm._ssd_chunked, static_argnums=(5,))
_ref_forward = jax.jit(jssm.mamba2_forward, static_argnums=(2,))
_ref_decode = jax.jit(jssm.mamba2_decode, static_argnums=(2,))


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


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, ref, atol=ATOL):
    ref = _f32(ref)
    np.testing.assert_allclose(_f32(got), ref, rtol=0,
                               atol=atol * max(1.0, float(np.abs(ref).max())))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp of each value (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _cfgs(arch="mamba2_130m", **over):
    return (jreduced(jget_config(arch)).with_overrides(**over),
            reduced(get_config(arch)).with_overrides(**over))


def _mixer(cfg, rng):
    """Mixer weights with A_log, dt_bias and D drawn too (their inits are
    zeros and ones, which would leave the decay and the skip untested)."""
    p = np_params(jssm.ssm_defs(cfg), rng)
    h = cfg.ssm_heads
    p["A_log"] = (0.5 * rng.standard_normal(h)).astype(np.float32)
    p["dt_bias"] = (0.5 * rng.standard_normal(h)).astype(np.float32)
    p["D"] = (1.0 + 0.3 * rng.standard_normal(h)).astype(np.float32)
    return p


def _setup(seed=0, length=L, **over):
    """(reference cfg, port cfg, params as jax and torch, x as jax and torch)
    in the compute dtype of ``over``."""
    jcfg, cfg = _cfgs(**over)
    rng = np.random.default_rng(seed)
    jp, tp = both(_mixer(jcfg, rng))
    x = rng.standard_normal((B, length, cfg.d_model)).astype(np.float32)
    return (jcfg, cfg, jp, tp, jnp.asarray(x).astype(jcfg.dtype("compute")),
            torch.from_numpy(x).to(cfg.dtype("compute")))


@pytest.mark.parametrize("arch", ["mamba2_130m", "zamba2_7b"])
def test_ssm_defs_equal_reference(arch):
    for jcfg, cfg in ((jget_config(arch), get_config(arch)), _cfgs(arch)):
        assert ssm.ssm_defs(cfg) == {k: ssm.PSpec(**vars(v))
                                     for k, v in jssm.ssm_defs(jcfg).items()}
        assert blocks.ssm_cache_defs(cfg, 3) == {
            k: ssm.PSpec(**vars(v)) for k, v in jblocks.ssm_cache_defs(jcfg, 3).items()}


# -- the causal convolution ----------------------------------------------------------

def _conv_inputs(seed=0, length=11, c=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, length, c)).astype(np.float32),
            (0.5 * rng.standard_normal((4, c))).astype(np.float32),
            rng.standard_normal((B, 3, c)).astype(np.float32))


@pytest.mark.parametrize("cached", [False, True])
def test_causal_conv_matches_reference(cached):
    u, w, c = _conv_inputs()
    ref_y, ref_c = _ref_conv(jnp.asarray(u), jnp.asarray(w), jnp.asarray(c) if cached else None)
    y, new = ssm._causal_conv(torch.from_numpy(u), torch.from_numpy(w),
                              torch.from_numpy(c) if cached else None)
    np.testing.assert_allclose(_f32(y), _f32(ref_y), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_f32(new), _f32(ref_c), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_f32(new), u[:, -3:])


@pytest.mark.parametrize("cached", [False, True])
def test_causal_conv_bf16_bit_for_bit(cached):
    """In bf16 the shift-sum rounds at each tap, in ascending order, as the
    reference does (eager and under jit alike): the same bits."""
    u, w, c = _conv_inputs(seed=1)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    tbf = lambda a: torch.from_numpy(a).bfloat16()
    for fn in (jssm._causal_conv, _ref_conv):
        ref_y, ref_c = fn(bf(u), bf(w), bf(c) if cached else None)
        y, new = ssm._causal_conv(tbf(u), tbf(w), tbf(c) if cached else None)
        assert y.dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(y), _f32(ref_y))
        np.testing.assert_array_equal(_f32(new), _f32(ref_c))


def test_causal_conv_streams():
    """L inputs, then k one at a time through the cache, equal one call over
    L + k."""
    u, w, _ = _conv_inputs(seed=2, length=14)
    tu, tw = torch.from_numpy(u), torch.from_numpy(w)
    whole, _ = ssm._causal_conv(tu, tw)
    y, cache = ssm._causal_conv(tu[:, :9], tw)
    parts = [y]
    for t in range(9, 14):
        y, cache = ssm._causal_conv(tu[:, t:t + 1], tw, cache)
        parts.append(y)
    np.testing.assert_allclose(_f32(torch.cat(parts, 1)), _f32(whole), rtol=0, atol=1e-6)


# -- the chunked SSD scan ---------------------------------------------------------------

def _naive_ssd(x, dt, a_log, bmat, cmat):
    """Token-by-token recurrence in float64: h = dA h + dt B x; y = C h
    (repro's oracle in tests/models/test_ssm.py)."""
    b, l, h, p = x.shape
    n = bmat.shape[-1]
    a = -np.exp(np.asarray(a_log, np.float64))
    state = np.zeros((b, h, p, n))
    ys = np.zeros((b, l, h, p))
    xf = np.asarray(x, np.float64)
    dtf = np.asarray(dt, np.float64)
    bf = np.asarray(bmat, np.float64)
    cf = np.asarray(cmat, np.float64)
    for t in range(l):
        da = np.exp(dtf[:, t] * a)                      # (B,H)
        contrib = np.einsum("bhp,bn,bh->bhpn", xf[:, t], bf[:, t], dtf[:, t])
        state = state * da[:, :, None, None] + contrib
        ys[:, t] = np.einsum("bhpn,bn->bhp", state, cf[:, t])
    return ys, state


def _ssd_inputs(seed, b=2, l=16, h=3, p=4, n=5, a_scale=0.5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, l, h)), 0).astype(np.float32)
    a_log = (a_scale * rng.standard_normal(h)).astype(np.float32)
    bmat = rng.standard_normal((b, l, n)).astype(np.float32)
    cmat = rng.standard_normal((b, l, n)).astype(np.float32)
    return x, dt, a_log, bmat, cmat


@pytest.mark.parametrize("chunk", [2, 4, 8])
def test_ssd_chunked_matches_reference_and_naive(chunk):
    args = _ssd_inputs(0)
    y, s = ssm._ssd_chunked(*map(torch.from_numpy, args), chunk)
    assert y.shape == (2, 16, 3, 4) and s.shape == (2, 3, 4, 5) and s.dtype == torch.float32
    ref_y, ref_s = _ref_ssd(*map(jnp.asarray, args), chunk)
    naive_y, naive_s = _naive_ssd(*args)
    for got, ref in ((y, ref_y), (s, ref_s), (y, naive_y), (s, naive_s)):
        np.testing.assert_allclose(_f32(got), _f32(ref), rtol=0, atol=SSD_ATOL)


def test_ssd_chunk_size_invariance():
    args = _ssd_inputs(1, b=1, l=24, h=2, n=3, a_scale=0.0)
    y3, s3 = ssm._ssd_chunked(*map(torch.from_numpy, args), 3)
    y8, s8 = ssm._ssd_chunked(*map(torch.from_numpy, args), 8)
    np.testing.assert_allclose(_f32(y3), _f32(y8), rtol=0, atol=SSD_ATOL)
    np.testing.assert_allclose(_f32(s3), _f32(s8), rtol=0, atol=SSD_ATOL)
    with pytest.raises(ValueError, match="not a multiple of the chunk 5"):
        ssm._ssd_chunked(*map(torch.from_numpy, args), 5)


def test_ssd_chunked_bf16_within_an_ulp():
    """bf16 x, B and C: the scores cast to bf16 before their product with
    x, as the reference casts them; y within one bf16 ulp of its values."""
    x, dt, a_log, bmat, cmat = _ssd_inputs(2, l=16, h=4, p=8, n=16)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    tbf = lambda a: torch.from_numpy(a).bfloat16()
    ref_y, ref_s = _ref_ssd(bf(x), jnp.asarray(dt), jnp.asarray(a_log), bf(bmat), bf(cmat), 8)
    y, s = ssm._ssd_chunked(tbf(x), torch.from_numpy(dt), torch.from_numpy(a_log), tbf(bmat),
                            tbf(cmat), 8)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    ref = _f32(ref_y)
    assert np.all(np.abs(_f32(y) - ref) <= _bf16_ulp(ref))
    np.testing.assert_allclose(_f32(s), _f32(ref_s), rtol=0, atol=SSD_ATOL)


# -- the Mamba-2 mixer ---------------------------------------------------------------

CACHE_KEYS = ("conv_x", "conv_B", "conv_C", "state")


def test_mamba2_forward_matches_reference():
    jcfg, cfg, jp, tp, jx, tx = _setup()
    ref, ref_cache = _ref_forward(jx, jp, jcfg)
    out, cache = ssm.mamba2_forward(tx, tp, cfg)
    assert out.shape == (B, L, cfg.d_model)
    _close(out, ref)
    assert sorted(cache) == sorted(ref_cache) == sorted(CACHE_KEYS)
    for k in CACHE_KEYS:
        assert tuple(cache[k].shape) == ref_cache[k].shape, k
        _close(cache[k], ref_cache[k])


def test_mamba2_decode_matches_reference():
    """Three steps from the prefill's cache: outputs and all four cache
    leaves, the leaves written in place."""
    jcfg, cfg, jp, tp, jx, tx = _setup(seed=1)
    _, ref_cache = _ref_forward(jx, jp, jcfg)
    _, cache = ssm.mamba2_forward(tx, tp, cfg)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    rng = np.random.default_rng(5)
    for _ in range(3):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        ref, ref_cache = _ref_decode(jnp.asarray(x), jp, jcfg, ref_cache)
        out, same = ssm.mamba2_decode(torch.from_numpy(x), tp, cfg, cache)
        assert same is cache and out.shape == (B, 1, cfg.d_model)
        _close(out, ref)
        for k in CACHE_KEYS:
            _close(cache[k], ref_cache[k])
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs


def test_mamba2_padding_leaves_the_final_state():
    """13 positions padded to 16 (chunk 8) and taken as one chunk of 13:
    the same outputs and final state."""
    _, cfg, _, tp, _, tx = _setup(seed=2)
    out8, c8 = ssm.mamba2_forward(tx, tp, cfg)
    out13, c13 = ssm.mamba2_forward(tx, tp, cfg.with_overrides(ssm_chunk=L))
    np.testing.assert_allclose(_f32(out8), _f32(out13), rtol=0, atol=SSD_ATOL)
    np.testing.assert_allclose(_f32(c8["state"]), _f32(c13["state"]), rtol=0, atol=SSD_ATOL)


def test_mamba2_bf16_matches_reference():
    jcfg, cfg, jp, tp, jx, tx = _setup(seed=3, compute_dtype="bfloat16")
    ref, ref_cache = _ref_forward(jx, jp, jcfg)
    out, cache = ssm.mamba2_forward(tx, tp, cfg)
    assert out.dtype == torch.bfloat16 and cache["state"].dtype == torch.bfloat16

    def within(got, ref, ulps):
        ref = _f32(ref)
        assert np.abs(_f32(got) - ref).max() <= ulps * _bf16_ulp(np.abs(ref).max())

    within(out, ref, 2)
    for k in CACHE_KEYS:
        within(cache[k], ref_cache[k], 1)
    x = np.random.default_rng(6).standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ref, ref_cache = _ref_decode(jnp.asarray(x).astype(jnp.bfloat16), jp, jcfg, ref_cache)
    out, cache = ssm.mamba2_decode(torch.from_numpy(x).bfloat16(), tp, cfg, cache)
    within(out, ref, 2)
    for k in CACHE_KEYS:
        within(cache[k], ref_cache[k], 1)


def test_ssm_block_prefill_and_decode_match_reference():
    """The block (rmsnorm, mixer, residual) as SSMBlock against the
    reference's ssm_block_prefill / ssm_block_decode."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(7)
    tree = {"ln": {"scale": (1 + 0.1 * rng.standard_normal(cfg.d_model)).astype(np.float32)},
            "mixer": _mixer(jcfg, rng)}
    jp, tp = both(tree)
    block = blocks.SSMBlock(cfg, tp)
    x = rng.standard_normal((B, L + 1, cfg.d_model)).astype(np.float32)
    _close(block(torch.from_numpy(x), None), jblocks.ssm_block(jnp.asarray(x), jp, jcfg))
    ref, ref_cache = jblocks.ssm_block_prefill(jnp.asarray(x[:, :L]), jp, jcfg)
    out, cache = block.prefill(torch.from_numpy(x[:, :L]), None, L + 4)
    _close(out, ref)
    ref, ref_cache = jblocks.ssm_block_decode(jnp.asarray(x[:, L:]), jp, jcfg, ref_cache, L)
    out, cache = block.decode(torch.from_numpy(x[:, L:]), cache, L)
    _close(out, ref)
    for k in CACHE_KEYS:
        _close(cache[k], ref_cache[k])
    # the decode step continues the prefill: it equals the last row of a
    # prefill over all L + 1 positions
    full, _ = block.prefill(torch.from_numpy(x), None, L + 4)
    np.testing.assert_allclose(_f32(out), _f32(full[:, L:]), rtol=0, atol=SSD_ATOL)
