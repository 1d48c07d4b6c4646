"""Integration domains: finite per-function boxes (PyTorch).

Port of the finite-box part of ``repro.core.domains``.  A domain is a
per-function box ``(n_fn, dim, 2)`` of ``[lo, hi]`` pairs; uniforms map
into it affinely.  Infinite edges (the tangent and rational
compactifications) come with the wrapper-stage slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch


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
