"""Integration domains (PyTorch port of ``repro.core.domains``).

A domain is a per-function box ``(n_fn, dim, 2)`` of ``[lo, hi]`` pairs.
Finite boxes map uniforms affinely; infinite and half-infinite edges use
the tangent and rational compactifications with their Jacobians folded
into the integrand value, so every solver only samples finite boxes.

The transform is static per (function, axis): a kind code plus a finite
shift, derived on the host from the domain array
(:func:`transform_params`).  The codes pack into kernel parameter
columns, and the CUDA kernel's compactified blocks apply the same map
as :func:`apply_transform` (``kernels/csrc/zmc_device.cuh``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Per-axis transform kind codes.  They also ride inside f32 kernel
# parameter columns, so they stay exact small ints.
TRANSFORM_NONE = 0   # finite edge: identity
TRANSFORM_TAN = 1    # (-inf, inf): x = tan(pi*(u - 1/2))
TRANSFORM_UPPER = 2  # [a,  inf):   x = a + u/(1-u)
TRANSFORM_LOWER = 3  # (-inf, b]:   x = b - u/(1-u)

# Samples are clamped into the open unit interval before transforming so
# the tangent/rational maps stay finite at the box edges.
CLIP_EPS = 1e-7


def box_volume(domains: torch.Tensor, dims=None) -> torch.Tensor:
    """Volume of each function's active box.

    Args:
      domains: (n_fn, dim, 2) tensor.
      dims: optional (n_fn,) active-dimension counts; padding dims are
        excluded by masking their width to 1.

    Returns: (n_fn,) volumes, in the dtype of ``domains``.
    """
    widths = domains[..., 1] - domains[..., 0]
    if dims is not None:
        d = torch.arange(domains.shape[1], device=domains.device)
        dims = torch.as_tensor(dims, device=domains.device)
        widths = torch.where(d[None, :] < dims[:, None], widths,
                             torch.ones_like(widths))
    return torch.prod(widths, dim=-1)


def affine_from_unit(u: torch.Tensor, domains: torch.Tensor) -> torch.Tensor:
    """Map unit-cube uniforms ``u`` (..., dim) into the box. Broadcasts."""
    lo = domains[..., 0]
    hi = domains[..., 1]
    return lo + u * (hi - lo)


def is_finite_box(domains) -> bool:
    if isinstance(domains, torch.Tensor):
        return bool(torch.isfinite(domains).all())
    return bool(np.all(np.isfinite(np.asarray(domains))))


def transform_params(domains):
    """Static per-(function, axis) compactification metadata.

    Args:
      domains: (n_fn, dim, 2) possibly-infinite boxes (array or tensor).

    Returns ``(kind, shift, new_domains)`` as host numpy arrays:
      kind: int32 (n_fn, dim) ``TRANSFORM_*`` code per axis;
      shift: float32 (n_fn, dim) finite anchor of half-infinite axes
        (the ``a`` of ``[a, inf)``, the ``b`` of ``(-inf, b]``), 0
        elsewhere;
      new_domains: float32 finite sampling box: transformed axes become
        [0, 1], finite axes keep their original edges.
    """
    if isinstance(domains, torch.Tensor):
        domains = domains.detach().cpu().numpy()
    domains = np.asarray(domains, np.float64)
    lo_inf = ~np.isfinite(domains[..., 0])
    hi_inf = ~np.isfinite(domains[..., 1])
    kind = np.where(lo_inf & hi_inf, TRANSFORM_TAN,
                    np.where(~lo_inf & hi_inf, TRANSFORM_UPPER,
                             np.where(lo_inf & ~hi_inf, TRANSFORM_LOWER,
                                      TRANSFORM_NONE)))
    shift = np.where(kind == TRANSFORM_UPPER, domains[..., 0],
                     np.where(kind == TRANSFORM_LOWER, domains[..., 1], 0.0))
    new_domains = domains.copy()
    transformed = kind != TRANSFORM_NONE
    new_domains[..., 0] = np.where(transformed, 0.0, domains[..., 0])
    new_domains[..., 1] = np.where(transformed, 1.0, domains[..., 1])
    return (kind.astype(np.int32), shift.astype(np.float32),
            new_domains.astype(np.float32))


def apply_transform(u: torch.Tensor, kind, shift):
    """Map samples of the finite sampling box through the per-axis
    compactification.

    ``kind``/``shift`` broadcast against ``u``; ``kind`` may be an
    integer or float tensor (the codes are exact small ints in f32).
    Returns ``(x, jac)``: original-space coordinates and the per-axis
    Jacobian ``dx/du`` (1 on finite axes, where ``x == u`` untouched by
    the clamp).  The plain version of the CUDA kernel's
    ``zmc::apply_transform``.
    """
    # the clamp bounds as f32 computes them (1 - eps rounds to 1 - 2^-23)
    uc = torch.clamp(u, float(np.float32(CLIP_EPS)),
                     float(np.float32(1.0) - np.float32(CLIP_EPS)))
    arg = math.pi * (uc - 0.5)
    tan_x = torch.tan(arg)
    tan_j = math.pi / torch.square(torch.cos(arg))
    rat = uc / (1.0 - uc)
    rat_j = 1.0 / torch.square(1.0 - uc)
    both = kind == TRANSFORM_TAN
    upper = kind == TRANSFORM_UPPER
    lower = kind == TRANSFORM_LOWER
    x = torch.where(both, tan_x,
                    torch.where(upper, shift + rat,
                                torch.where(lower, shift - rat, u)))
    jac = torch.where(both, tan_j,
                      torch.where(upper | lower, rat_j, torch.ones_like(uc)))
    return x, jac


def compactify(fn, domains):
    """Rewrite (fn, domains) with infinite edges into a finite-box problem.

    Per-dimension rules (u is the coordinate sampled in the new box):

    * ``(-inf, inf)``  -> x = tan(pi*(u - 1/2)),  u in (0, 1),  J = pi*sec^2
    * ``[a,  inf)``    -> x = a + u/(1-u),        u in [0, 1),  J = 1/(1-u)^2
    * ``(-inf, b]``    -> x = b - u/(1-u),        u in [0, 1),  J = 1/(1-u)^2
    * finite           -> identity

    ``fn`` is batched (``fn(x, p)`` with ``x`` of shape (n_fn, B, dim)).
    Returns ``(fn2, domains2, aux)``: ``fn2(u, params)`` evaluates the
    original integrand times the Jacobian, with ``params`` the
    ``{"inner": user params, "aux": {"kind", "shift"}}`` wrapper;
    ``domains2`` is a finite float32 tensor; ``aux`` holds the
    (n_fn, dim) int32 ``kind`` and float32 ``shift`` tensors.  Finite
    boxes return ``(fn, domains)`` unchanged.
    """
    device = domains.device if isinstance(domains, torch.Tensor) else "cpu"
    if is_finite_box(domains):
        return fn, torch.as_tensor(domains, dtype=torch.float32, device=device)
    kind, shift, new_domains = transform_params(domains)
    if kind.ndim != 2:
        raise ValueError("compactify expects (n_fn, dim, 2) domains")
    aux = {"kind": torch.from_numpy(kind).to(device),
           "shift": torch.from_numpy(shift).to(device)}
    return compactified_fn(fn), torch.from_numpy(new_domains).to(device), aux


def compactified_fn(fn):
    """The batched integrand of a compactified family: ``fn2(u, p)`` maps
    ``u`` (n_fn, B, dim) through ``p["aux"]``'s transforms and returns
    ``fn(x, p["inner"])`` times the Jacobian product."""

    def transformed(u, wrapped):
        a = wrapped["aux"]
        x, jac = apply_transform(u, a["kind"][:, None, :],
                                 a["shift"][:, None, :])
        return fn(x, wrapped["inner"]) * torch.prod(jac, dim=-1)

    return transformed
