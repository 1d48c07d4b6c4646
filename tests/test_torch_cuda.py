"""The CUDA kernels on the card: the fused kernel against its plain
version, bit-identical repeats and row independence, the device
Threefry bit for bit, and the solver on the card against the CPU.

Marked ``cuda``; each test skips (with the reason) where there is no GPU.
On a machine with one:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import genz, integrand, rng
from repro_torch.core.multifunctions import ZMCMultiFunctions
from repro_torch.kernels import template
from repro_torch.kernels.mc_eval import multi

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (nvcc builds the kernel on first use)")
    return torch.device("cuda", 0)


def _spec(device):
    return integrand.MultiFunctionSpec.from_families([
        integrand.harmonic_family(40, 3),
        integrand.abs_sum_family(9, 3, np.linspace(0.5, 2, 9), sign_last=-1.0),
        integrand.gaussian_family(7, 3),
        genz.oscillatory(21, 3)[0],
        genz.corner_peak(6, 3)[0],
    ]).to(device)


def _launch(fn, b, n, key, offset=0):
    return fn(template.pack_scalars(key, offset, n), b.fn_ids, b.packed, b.lo,
              b.hi, b.block_forms, dim=b.dim,
              n_sample_blocks=math.ceil(n / template.S_BLK))[0]


@pytest.mark.parametrize("n,offset", [(1, 0), (2048 * 9 + 5, 2**32 - 20000),
                                      (65536, 12345)])
def test_kernel_vs_plain_mixed_bucket(cuda, n, offset):
    (b,) = multi.plan_spec(_spec(cuda)).buckets
    key = rng.fold_key(9, 4)
    template.reset_kernel_launch_count()
    got = _launch(template.fused_mc_cuda, b, n, key, offset)
    assert template.kernel_launch_count() == 1
    want = _launch(template.fused_mc_plain, b, n, key, offset)
    real = torch.cat([torch.arange(s.row_start, s.row_start + s.n_fn)
                      for s in b.slices]).to(cuda)
    torch.testing.assert_close(got[real], want[real], rtol=1e-4, atol=1e-2)


def test_repeats_and_rows_are_bit_identical(cuda):
    (b,) = multi.plan_spec(_spec(cuda)).buckets
    key = rng.fold_key(1, 1)
    a = _launch(template.fused_mc_cuda, b, 50_000, key)
    again = _launch(template.fused_mc_cuda, b, 50_000, key)
    # bit patterns: the gaussian's zero padding rows sum NaN (0/0), as in repro
    assert torch.equal(a.view(torch.int32), again.view(torch.int32))
    s = b.slices[0]                         # the harmonic family, alone
    rows = slice(s.row_start, s.row_start + math.ceil(s.n_fn / 16) * 16)
    one = template.fused_mc_cuda(
        template.pack_scalars(key, 0, 50_000), b.fn_ids[rows],
        b.packed[rows].contiguous(), b.lo[rows].contiguous(),
        b.hi[rows].contiguous(), b.block_forms[:rows.stop // 16], dim=b.dim,
        n_sample_blocks=math.ceil(50_000 / template.S_BLK))[0]
    assert torch.equal(one[:s.n_fn], a[:s.n_fn])


def test_device_threefry_bit_exact(cuda):
    i = torch.arange(1 << 16, dtype=torch.int64, device=cuda)
    c0 = (2**32 - 1000 + i) & rng.MASK32
    c1 = ((i * 40503) % (1 << 24)) * rng.DIM_STRIDE + i % rng.DIM_STRIDE
    got = template.random_bits_cuda(7, 8, c0, c1)
    assert torch.equal(got, rng.random_bits(7, 8, c0, c1))


def test_solver_on_card_vs_cpu(cuda):
    kw = dict(n_samples=30_000, seed=2, use_kernel=True)
    gpu = ZMCMultiFunctions(_spec("cpu"), device="cuda", **kw).evaluate(2)
    cpu = ZMCMultiFunctions(_spec("cpu"), device="cpu", **kw).evaluate(2)
    np.testing.assert_allclose(gpu.means, cpu.means, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(gpu.stderrs, cpu.stderrs, rtol=1e-3, atol=1e-3)
