"""Harmonic eval body and packer (port of ``repro.kernels.mc_eval.kernel``).

The fused sampling, domain mapping and reduction live in
``repro_torch.kernels.template`` (plain version and CUDA wrapper) and in
``kernels/csrc/fused_mc.cu``; this module contributes the harmonic
**eval body** (the plain version of ``zmc::Body<FORM_HARMONIC>``) and its
**param packing**, cols = [a, b, k_0..k_{dim-1}].
"""

from __future__ import annotations

import torch


def harmonic_body(draw, p, dim: int):
    """f(x) = a cos(k.x) + b sin(k.x); packed cols [a, b, k_0..k_{dim-1}]."""
    phase = torch.zeros_like(draw(0))
    for d in range(dim):
        phase = phase + p[:, 2 + d:3 + d] * draw(d)
    return p[:, 0:1] * torch.cos(phase) + p[:, 1:2] * torch.sin(phase)


def pack_harmonic(family):
    """f32[n_fn, 2 + dim] packed (a, b, k) parameters."""
    prm = family.params
    if not {"a", "b", "k"} <= set(prm):
        raise ValueError("harmonic kernel needs params {'a','b','k'}")
    n_fn, dim = family.n_fn, family.dim
    return torch.cat([
        prm["a"].to(torch.float32).reshape(n_fn, 1),
        prm["b"].to(torch.float32).reshape(n_fn, 1),
        prm["k"].to(torch.float32).reshape(n_fn, dim),
    ], dim=1)
