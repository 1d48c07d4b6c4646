"""Port's counter RNG (repro_torch.core.rng) against repro.core.rng, bit
for bit: Threefry words, bits, uniforms, keys and the counter layout,
including counters at the c0 wrap and the largest function id."""

import numpy as np
import pytest
import torch

from repro.core import rng as jrng
from repro_torch.core import rng

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

U32 = 2**32


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _counters(seed: int, n: int = 4096):
    r = np.random.default_rng(seed)
    c0 = r.integers(0, U32, n, dtype=np.uint64).astype(np.uint32)
    c0[:256] = (U32 - 128 + np.arange(256)) % U32            # across the wrap
    fn = r.integers(0, 2**24, n, dtype=np.uint64)
    fn[:16] = 2**24 - 1                                      # largest fn id
    d = r.integers(0, rng.DIM_STRIDE, n, dtype=np.uint64)
    d[:16] = rng.DIM_STRIDE - 1
    c1 = (fn * rng.DIM_STRIDE + d).astype(np.uint32)
    return c0, c1


@pytest.mark.parametrize("seed,stream", [(0, 0), (1, 0), (0, 1), (2**40 + 5, 3),
                                         (123456789, 2**32 - 1)])
def test_fold_key(seed, stream):
    want = jrng.fold_key(seed, stream)
    assert rng.fold_key(seed, stream) == (int(want[0]), int(want[1]))


@pytest.mark.parametrize("seed", [0, 1])
def test_threefry_both_words(seed):
    c0, c1 = _counters(seed)
    k0, k1 = jrng.fold_key(seed, 9)
    w0, w1 = jrng.threefry2x32(k0, k1, c0, c1)
    g0, g1 = rng.threefry2x32(int(k0), int(k1), c0, c1)
    np.testing.assert_array_equal(_np(g0), np.asarray(w0))
    np.testing.assert_array_equal(_np(g1), np.asarray(w1))


def test_random_bits_and_uniforms_from_tensors():
    c0, c1 = _counters(2)
    k0, k1 = jrng.fold_key(77, 1)
    want = np.asarray(jrng.random_bits(k0, k1, c0, c1))
    got = rng.random_bits(int(k0), int(k1), torch.from_numpy(c0.astype(np.int64)),
                          torch.from_numpy(c1.view(np.int32)))   # int32 bit patterns
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        rng.bits_to_uniform(got).numpy(),
        np.asarray(jrng.bits_to_uniform(jrng.random_bits(k0, k1, c0, c1))))


def test_counter_c1_and_dim_stride():
    assert rng.DIM_STRIDE == jrng.DIM_STRIDE == 256
    fn = np.array([0, 1, 5, 2**24 - 1, 2**24, 2**31], np.uint32)
    d = np.array([0, 255, 3, 255, 1, 7], np.uint32)
    np.testing.assert_array_equal(_np(rng.counter_c1(fn, d)),
                                  np.asarray(jrng.counter_c1(fn, d)))


@pytest.mark.parametrize("fn_offset,sample_offset,n_dim", [
    (0, 0, 1), (1000, 12345, 3), (2**24 - 4, U32 - 100, 4)])
def test_uniforms_for(fn_offset, sample_offset, n_dim):
    k0, k1 = jrng.fold_key(5, 2)
    fn_ids = (fn_offset + np.arange(4)).astype(np.uint32)
    sample_ids = ((sample_offset + np.arange(300)) % U32).astype(np.uint32)
    want = np.asarray(jrng.uniforms_for(k0, k1, fn_ids, sample_ids, n_dim))
    got = rng.uniforms_for(int(k0), int(k1), fn_ids, sample_ids, n_dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_u32_bits_round_trip():
    x = torch.tensor([0, 1, 2**31 - 1, 2**31, U32 - 1], dtype=torch.int64)
    b = rng.u32_bits(x)
    assert b.dtype == torch.int32
    np.testing.assert_array_equal(rng.as_u32(b).numpy(), x.numpy())
    np.testing.assert_array_equal(b.numpy().view(np.uint32), x.numpy())
