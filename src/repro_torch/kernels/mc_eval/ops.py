"""Registered kernel forms for the direct-MC engine (port of
``repro.kernels.mc_eval.ops``).

Each form is a plain eval body + param packer + capability metadata
(:class:`repro_torch.kernels.registry.KernelForm`).  Form ids are the
indices of the bodies in the CUDA kernel's switch
(``kernels/csrc/zmc_device.cuh``), in registration order: harmonic 0,
abs_sum 1, gaussian 2, genz_osc 3, genz_corner 4.

A body takes ``draw(d)`` -> (F, S) samples of dimension ``d`` and the
(F, n_cols) packed block ``p``, and returns (F, S) values; it adds its
per-dimension terms in the same order as ``repro``'s body and the CUDA
body.

``sweep_cols`` maps each sweepable template parameter to the base packed
columns it occupies (``template.sweep_col_map``), as ``repro``'s forms
declare them.  genz_osc's ``u`` is absent on purpose: its packer keeps
only ``u[:, :1]`` of a dim-wide leaf, so a per-point table could not
round-trip through the columns.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.mc_eval.kernel import harmonic_body, pack_harmonic
from repro_torch.kernels.registry import KernelForm


def abs_sum_body(draw, p, dim: int):
    """g(x) = c * |sum_d s_d x_d|; packed cols [c, s_0..s_{dim-1}]."""
    acc = torch.zeros_like(draw(0))
    for d in range(dim):
        acc = acc + p[:, 1 + d:2 + d] * draw(d)
    return p[:, 0:1] * torch.abs(acc)


def pack_abs_sum(family):
    prm = family.params
    if not {"c", "s"} <= set(prm):
        raise ValueError("abs_sum kernel needs params {'c','s'}")
    n_fn, dim = family.n_fn, family.dim
    return torch.cat([
        prm["c"].to(torch.float32).reshape(n_fn, 1),
        prm["s"].to(torch.float32).reshape(n_fn, dim),
    ], dim=1)


def genz_osc_body(draw, p, dim: int):
    """Genz oscillatory cos(2 pi u_1 + sum a_d x_d); cols [u_1, a_0..]."""
    phase = torch.full_like(draw(0), 2.0 * math.pi) * p[:, 0:1]
    for d in range(dim):
        phase = phase + p[:, 1 + d:2 + d] * draw(d)
    return torch.cos(phase)


def pack_genz_osc(family):
    prm = family.params
    if not {"a", "u"} <= set(prm):
        raise ValueError("genz oscillatory kernel needs params {'a','u'}")
    n_fn, dim = family.n_fn, family.dim
    return torch.cat([
        prm["u"].to(torch.float32).reshape(n_fn, dim)[:, :1],
        prm["a"].to(torch.float32).reshape(n_fn, dim),
    ], dim=1)


def genz_corner_body(draw, p, dim: int):
    """Genz corner peak (1 + sum a_d x_d)^-(dim+1); cols [a_0..a_{dim-1}].

    Computed as exp(-(dim+1) log(base)): branch-free, and safe for padded
    zero rows (base 1).
    """
    acc = torch.ones_like(draw(0))
    for d in range(dim):
        acc = acc + p[:, d:d + 1] * draw(d)
    return torch.exp(-(dim + 1.0) * torch.log(acc))


def pack_genz_corner(family):
    prm = family.params
    if "a" not in prm:
        raise ValueError("genz corner-peak kernel needs params {'a'}")
    return prm["a"].to(torch.float32).reshape(family.n_fn, family.dim)


def gaussian_body(draw, p, dim: int):
    """f(x) = exp(-0.5 ||x||^2 / sigma^2); packed cols [sigma]."""
    r2 = torch.zeros_like(draw(0))
    for d in range(dim):
        x = draw(d)
        r2 = r2 + x * x
    return torch.exp(-0.5 * r2 / (p[:, 0:1] * p[:, 0:1]))


def pack_gaussian(family):
    prm = family.params
    if "sigma" not in prm:
        raise ValueError("gaussian kernel needs params {'sigma'}")
    return prm["sigma"].to(torch.float32).reshape(family.n_fn, 1)


HARMONIC = registry.register_form(KernelForm(
    name="mc_eval_harmonic", form_id=0, body=harmonic_body,
    pack_params=pack_harmonic, n_cols=lambda dim: 2 + dim,
    sweep_cols=lambda dim: {"a": (0,), "b": (1,),
                            "k": tuple(range(2, 2 + dim))}))

ABS_SUM = registry.register_form(KernelForm(
    name="mc_eval_abs_sum", form_id=1, body=abs_sum_body,
    pack_params=pack_abs_sum, n_cols=lambda dim: 1 + dim,
    sweep_cols=lambda dim: {"c": (0,), "s": tuple(range(1, 1 + dim))}))

GAUSSIAN = registry.register_form(KernelForm(
    name="mc_eval_gaussian", form_id=2, body=gaussian_body,
    pack_params=pack_gaussian, n_cols=lambda dim: 1,
    sweep_cols=lambda dim: {"sigma": (0,)}))

GENZ_OSC = registry.register_form(KernelForm(
    name="mc_eval_genz_osc", form_id=3, body=genz_osc_body,
    pack_params=pack_genz_osc, n_cols=lambda dim: 1 + dim,
    sweep_cols=lambda dim: {"a": tuple(range(1, 1 + dim))}))

GENZ_CORNER = registry.register_form(KernelForm(
    name="mc_eval_genz_corner", form_id=4, body=genz_corner_body,
    pack_params=pack_genz_corner, n_cols=lambda dim: dim,
    sweep_cols=lambda dim: {"a": tuple(range(dim))}))

# Directly importable single-family impls (repro's historical names).
mc_eval_harmonic = registry.impl("mc_eval_harmonic")
mc_eval_sobol_harmonic = registry.impl("mc_eval_harmonic@sobol")
mc_eval_abs_sum = registry.impl("mc_eval_abs_sum")
mc_eval_gaussian = registry.impl("mc_eval_gaussian")
