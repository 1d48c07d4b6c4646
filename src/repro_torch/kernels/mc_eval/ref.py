"""Plain oracle for the harmonic kernel (port of
``repro.kernels.mc_eval.ref``).

Written straight from the definition, independent of the fused
template: per 2048-sample block, draw the Threefry uniforms of every
(function, sample, dim), evaluate a cos(k.x) + b sin(k.x), mask the
samples past ``n_valid`` and fold the block sums in order.
"""

from __future__ import annotations

import torch

from repro_torch.core import rng as rng_lib
from repro_torch.kernels.template import S_BLK


def mc_harmonic_ref(scalars, fn_ids, a, b, k, lo, hi, *, dim: int,
                    n_sample_blocks: int) -> torch.Tensor:
    """Reference (sum f, sum f^2) per function, f32[n_fn, 2].

    Args:
      scalars: u32[4] (k0, k1, sample_offset, n_valid).
      fn_ids: u32[n_fn] global function ids.
      a, b: f32[n_fn, 1]; k, lo, hi: f32[n_fn, dim].
    """
    k0, k1, sample_offset, n_valid = (int(v) for v in scalars.tolist())
    device = k.device
    fn_ids = rng_lib.as_u32(fn_ids, device)
    d = torch.arange(dim, dtype=torch.int64, device=device)
    c1 = rng_lib.counter_c1(fn_ids[:, None, None], d[None, None, :])
    out = torch.zeros(fn_ids.shape[0], 2, dtype=torch.float32, device=device)
    for j in range(n_sample_blocks):
        local = j * S_BLK + torch.arange(S_BLK, dtype=torch.int64,
                                         device=device)
        c0 = (sample_offset + local) & rng_lib.MASK32
        u = rng_lib.bits_to_uniform(
            rng_lib.random_bits(k0, k1, c0[None, :, None], c1))
        x = lo[:, None, :] + u * (hi - lo)[:, None, :]
        phase = torch.sum(x * k[:, None, :], dim=-1)
        val = a * torch.cos(phase) + b * torch.sin(phase)
        val = torch.where(local[None, :] < n_valid, val, torch.zeros_like(val))
        out = out + torch.stack([val.sum(-1), (val * val).sum(-1)], dim=-1)
    return out
