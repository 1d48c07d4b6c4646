"""The fused kernel with Sobol (RQMC) points on one harmonic family (port
of ``repro.kernels.mc_eval.sobol_kernel``).

The same launch as the Threefry one (:func:`repro_torch.kernels.template
.fused_mc` with ``sampler="sobol"``): the Sobol point of each sample is
shared by the 16 functions of a block, so the Gray-code XOR runs once per
(sample, dim) and each function pays only its digital shift's XOR and
the affine map.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import template
from repro_torch.kernels.mc_eval.ops import HARMONIC


def mc_sobol_harmonic(scalars, fn_ids, a, b, k, lo, hi, *, dim: int,
                      n_sample_blocks: int) -> torch.Tensor:
    """Historical entry point: (sum f, sum f^2) per function, f32[n_fn_pad, 2].

    Args:
      scalars: u32[4] (k0, k1, sample_offset, n_valid) (``pack_scalars``).
      fn_ids: u32[n_fn_pad], n_fn_pad a multiple of 16.
      a, b: f32[n_fn_pad, 1]; k, lo, hi: f32[n_fn_pad, dim].
    """
    packed = torch.cat([a, b, k], dim=1).to(torch.float32).contiguous()
    forms = torch.full((fn_ids.shape[0] // template.F_BLK,), HARMONIC.form_id,
                       dtype=torch.int32)
    return template.fused_mc(
        scalars, fn_ids, packed, lo.contiguous(), hi.contiguous(), forms,
        dim=dim, n_sample_blocks=n_sample_blocks, sampler="sobol")[0]
