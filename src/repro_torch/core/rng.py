"""Counter-based random numbers for Monte-Carlo sampling (PyTorch).

Port of ``repro.core.rng``: Threefry-2x32 (20 rounds, Random123), where
every uniform is a pure function ``u = T(key, counter)`` of a 64-bit key
and a 64-bit counter, so any device, split or restart draws the same
sample stream.  The CUDA kernel (``kernels/csrc/zmc_device.cuh``) computes
the same bits; the tests hold both against ``repro`` bit for bit.

u32 arithmetic is done in ``torch.int64`` with ``& 0xFFFFFFFF`` masks:
PyTorch's CPU ``uint32`` has no add, shift or compare.  Every function
here takes python ints, numpy arrays or tensors holding u32 values and
returns int64 tensors with values in ``[0, 2**32)``.

Counter layout:
  ``c0 = sample_index`` (u32, wraps at 2**32)
  ``c1 = function_id * DIM_STRIDE + dim_index`` (u32)
"""

from __future__ import annotations

import numpy as np
import torch

# Up to 256 dims per integrand; function_id occupies the high 24 bits of c1.
DIM_STRIDE = 256

MASK32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
# Threefry-2x32 rotation schedule (two alternating groups of four rounds).
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_INV_2_24 = 1.0 / (1 << 24)


def as_u32(x, device=None) -> torch.Tensor:
    """int64 tensor of the u32 values in ``x`` (int, numpy array, or a
    tensor of any integer dtype; int32 tensors are read as bit patterns)."""
    if isinstance(x, torch.Tensor):
        t = x.to(device=device) if device is not None else x
        if t.dtype == torch.uint32:
            t = t.view(torch.int32)
        return t.to(torch.int64) & MASK32
    arr = np.asarray(x)
    if arr.dtype.kind not in "iub":
        raise TypeError(f"counters and keys must be integers; got {arr.dtype}")
    t = torch.from_numpy(np.asarray(arr.astype(np.int64) & MASK32))
    return t if device is None else t.to(device)


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor with the bit patterns of u32 values held in int64
    (what a kernel reading ``uint32_t*`` expects)."""
    x = x & MASK32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, c0, c1):
    """Full 20-round Threefry-2x32 block cipher; both output words.

    Inputs broadcast; tensors decide the device (the first tensor among
    ``c0, c1, k0, k1``)."""
    device = next((t.device for t in (c0, c1, k0, k1)
                   if isinstance(t, torch.Tensor)), None)
    k0, k1, c0, c1 = (as_u32(v, device) for v in (k0, k1, c0, c1))
    x0 = (c0 + k0) & MASK32
    x1 = (c1 + k1) & MASK32
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & MASK32
        x1 = (x1 + ks[(group + 2) % 3] + (group + 1)) & MASK32
    return x0, x1


def random_bits(k0, k1, c0, c1):
    """First output word of the Threefry block — one u32 per counter."""
    return threefry2x32(k0, k1, c0, c1)[0]


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Top 24 bits times 2**-24: float32 uniforms in [0, 1), exact."""
    return (bits >> 8).to(torch.float32) * _INV_2_24


def fold_key(seed: int, stream: int = 0) -> tuple[int, int]:
    """Derive a (k0, k1) key pair from a python seed and a stream index."""
    seed = int(seed)
    k0 = seed & MASK32
    k1 = ((seed >> 32) & MASK32) ^ (int(stream) & MASK32)
    # one mixing round so that (seed=0, stream=0) and (seed=0, stream=1)
    # do not share a trivially-related key
    m0, m1 = threefry2x32(k0, k1, 0x9E3779B9, 0x7F4A7C15)
    return int(m0), int(m1)


def counter_c1(fn_ids, dims):
    """c1 word for (function_id, dim) pairs. Shapes broadcast."""
    device = next((t.device for t in (fn_ids, dims)
                   if isinstance(t, torch.Tensor)), None)
    return (as_u32(fn_ids, device) * DIM_STRIDE + as_u32(dims, device)) & MASK32


def uniforms_for(k0, k1, fn_ids, sample_ids, n_dim: int, *, device=None):
    """Uniforms for a (function, sample, dim) grid.

    Args:
      k0, k1: u32 key words.
      fn_ids: (F,) global function ids.
      sample_ids: (S,) global sample indices (u32).
      n_dim: number of dimensions to draw.
      device: where to draw (default: the device of ``fn_ids`` if it is a
        tensor, else the CPU).

    Returns:
      (F, S, n_dim) float32 uniforms in [0, 1).
    """
    if device is None and isinstance(fn_ids, torch.Tensor):
        device = fn_ids.device
    fn_ids = as_u32(fn_ids, device)
    sample_ids = as_u32(sample_ids, device)
    d = torch.arange(n_dim, dtype=torch.int64, device=fn_ids.device)
    c1 = counter_c1(fn_ids[:, None, None], d[None, None, :])
    c0 = sample_ids[None, :, None]
    return bits_to_uniform(random_bits(k0, k1, c0, c1))
