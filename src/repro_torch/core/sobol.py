"""Randomised Sobol quasi-Monte-Carlo sampling (PyTorch port of
``repro.core.sobol``).

A digitally shifted Sobol low-discrepancy sequence converges like
N^-1 (log N)^d on smooth integrands, against N^-1/2 for pseudo-random
MC, for the same sample budget.

* Direction numbers: Joe-Kuo D6 for dimensions 2..8 (dimension 1 is van
  der Corput).  Above ``MAX_DIM`` the engine degrades to pseudo-random
  MC, as ``repro`` does.
* Point ``i`` is built *by index*: the XOR of the direction vectors
  selected by the bits of ``gray(i)``, so it is counter-addressed like
  the Threefry path and any split or restart draws the same points.
* Randomisation: a per-(function, dimension) digital shift drawn from
  the Threefry key on its own counter plane (``c0 = 0x50B01``), so
  trials and functions are independently randomised.

u32 arithmetic is int64 with ``& 0xFFFFFFFF`` masks, as in
:mod:`repro_torch.core.rng`.  The CUDA kernel builds the same points and
shifts (``kernels/csrc/zmc_device.cuh``); the tests hold both against
``repro`` bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import rng

MAX_DIM = 8
_BITS = 32
# Counter plane of the digital shifts: c0 is this constant, c1 the usual
# fn_id * DIM_STRIDE + d, so shifts never collide with the sample stream.
SHIFT_C0 = 0x50B01

# Joe-Kuo D6: (s, a, m[1..s]) per dimension (dimension 1 is separate).
_JOE_KUO = {
    2: (1, 0, [1]),
    3: (2, 1, [1, 3]),
    4: (3, 1, [1, 3, 1]),
    5: (3, 2, [1, 1, 1]),
    6: (4, 1, [1, 1, 3, 3]),
    7: (4, 4, [1, 3, 5, 13]),
    8: (5, 2, [1, 1, 5, 5, 17]),
}


@functools.lru_cache(maxsize=None)
def direction_vectors(dim: int) -> np.ndarray:
    """(dim, 32) uint32 direction vectors V[d, j].  Row ``d`` does not
    depend on ``dim``, so every table is a prefix of the ``MAX_DIM`` one."""
    if dim > MAX_DIM:
        raise ValueError(f"sobol supports dim <= {MAX_DIM}; got {dim}")
    v = np.zeros((dim, _BITS), np.uint64)
    for j in range(_BITS):
        v[0, j] = 1 << (31 - j)
    for d in range(2, dim + 1):
        s, a, m = _JOE_KUO[d]
        row = v[d - 1]
        for j in range(min(s, _BITS)):
            row[j] = np.uint64(m[j]) << (31 - j)
        for j in range(s, _BITS):
            x = row[j - s] ^ (row[j - s] >> np.uint64(s))
            for k in range(1, s):
                if (a >> (s - 1 - k)) & 1:
                    x ^= row[j - k]
            row[j] = x
    out = v.astype(np.uint32)
    out.flags.writeable = False
    return out


def sobol_bits(indices, dim: int) -> torch.Tensor:
    """Raw Sobol integer points: int64 u32 values shaped
    ``indices.shape + (dim,)`` for u32 point indices (any shape)."""
    idx = rng.as_u32(indices)
    v = torch.from_numpy(direction_vectors(dim).astype(np.int64)).to(idx.device)
    gray = idx ^ (idx >> 1)
    acc = torch.zeros(gray.shape + (dim,), dtype=torch.int64, device=idx.device)
    for j in range(_BITS):
        bit = (gray >> j) & 1
        acc = acc ^ (bit[..., None] * v[:, j])
    return acc


def shifts_for(k0, k1, fn_ids, dim: int) -> torch.Tensor:
    """Per-(function, dim) digital-shift words, int64 u32 values (F, dim)."""
    fn_ids = rng.as_u32(fn_ids)
    d = torch.arange(dim, dtype=torch.int64, device=fn_ids.device)
    c1 = rng.counter_c1(fn_ids[:, None], d[None, :])
    return rng.random_bits(k0, k1, torch.full_like(c1, SHIFT_C0), c1)


def sobol_uniforms_for(k0, k1, fn_ids, sample_ids, n_dim: int) -> torch.Tensor:
    """Drop-in for ``rng.uniforms_for`` with shifted Sobol points:
    (F, S, n_dim) float32 in [0, 1)."""
    if isinstance(fn_ids, torch.Tensor):
        sample_ids = rng.as_u32(sample_ids, fn_ids.device)
    pts = sobol_bits(sample_ids, n_dim)                   # (S, dim)
    shift = shifts_for(k0, k1, fn_ids, n_dim)             # (F, dim)
    return rng.bits_to_uniform(pts[None, :, :] ^ shift[:, None, :])
