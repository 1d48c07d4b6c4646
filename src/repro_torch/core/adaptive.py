"""VEGAS importance grids (PyTorch port of ``repro.core.adaptive``).

A separable per-axis importance grid whose inverse-CDF map concentrates
samples where a pilot found variance, with the Jacobian folded into the
integrand value (Lepage's VEGAS, adapted for batch evaluation):

* :func:`initial_edges` — the uniform (identity-map) grid over a finite
  box;
* :func:`pilot_weights` — per-(function, axis, bin) importance from a
  counter-based pilot (``repro_torch.core.rng``): same key, same weights
  on one device, after any restart;
* :func:`refine_edges` — the smoothed, damped equal-importance
  redistribution, pure numpy, no RNG;
* :func:`apply_map` — the piecewise-linear map ``u -> (x, jacobian)`` the
  chunked path evaluates; the fused kernel applies the same arithmetic
  per axis (``kernels/csrc/zmc_device.cuh`` ``apply_map_axis``, and
  ``repro_torch.kernels.template.adapted_body`` in its plain version).

:func:`region_scores` grades how non-uniform an integrand's mass is with
a coarse stratified scan (:mod:`repro_torch.core.stratified`).

``initial_edges`` and ``refine_edges`` are numpy, as ``repro``'s are, and
give its bits.  ``pilot_weights`` sums in float32 in another order than
``repro``'s ``einsum``, so its weights agree within float32 tolerance and
a fresh fit's edges differ from ``repro``'s in their low bits.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import rng
from repro_torch.core import stratified
from repro_torch.device import resolve_device

# Bins per axis (dim * 17 packed f32 columns per function row).
N_BINS = 16

# Damping exponent of the refinement step (Lepage's alpha).
ALPHA = 1.5

# Every old bin keeps at least this fraction of the mean per-bin
# importance, so pilot-empty bins never collapse a new bin to zero width.
_MIN_IMPORTANCE = 1e-3


def initial_edges(domains, n_bins: int = N_BINS) -> np.ndarray:
    """Uniform per-axis bin edges over a finite box.

    Args:
      domains: (n_fn, dim, 2) finite [lo, hi] boxes (array or tensor).
    Returns:
      float32 (n_fn, dim, n_bins + 1) edges; the induced map is affine.
    """
    if isinstance(domains, torch.Tensor):
        domains = domains.detach().cpu().numpy()
    domains = np.asarray(domains, np.float64)
    if not np.all(np.isfinite(domains)):
        raise ValueError("importance grids need a finite box — "
                         "compactify the family first")
    lo = domains[..., :1]
    hi = domains[..., 1:]
    t = np.linspace(0.0, 1.0, int(n_bins) + 1)
    return (lo + t * (hi - lo)).astype(np.float32)


def apply_map(u: torch.Tensor, edges: torch.Tensor):
    """Piecewise-linear inverse-CDF map through an importance grid.

    Args:
      u: (..., dim) float32 uniforms in [0, 1).
      edges: (..., dim, n_bins + 1) per-axis edges, strictly increasing;
        leading axes broadcast against ``u``'s.
    Returns:
      ``(x, jac)``: mapped points of ``u``'s shape and the per-point
      Jacobian ``prod_d n_bins * width(selected bin)``.
    """
    edges = edges.to(torch.float32)
    n_bins = edges.shape[-1] - 1
    s = u * float(n_bins)
    idx = torch.clamp(s.to(torch.int64), max=n_bins - 1)
    frac = s - idx.to(torch.float32)
    e = edges.expand(u.shape + (n_bins + 1,))
    e0 = torch.gather(e, -1, idx[..., None])[..., 0]
    e1 = torch.gather(e, -1, idx[..., None] + 1)[..., 0]
    x = e0 + frac * (e1 - e0)
    jac = torch.prod((e1 - e0) * float(n_bins), dim=-1)
    return x, jac


def pilot_weights(family, edges, key, n_samples: int) -> np.ndarray:
    """Per-(function, axis, bin) importance from one deterministic pilot.

    Draws ``n_samples`` counter-addressed uniforms per function
    (:func:`repro_torch.core.rng.uniforms_for` under ``key``) on the
    family's device, maps them through the current grid, and bins the
    squared weighted integrand ``(f(x) * jac)^2`` by grid cell.  The bins
    are one-hot sums in float32 (one reduction per bin, no atomics), so
    the same (family, edges, key) give the same weights on one device.

    Args:
      family: a finite-box unadapted family (the base stream).
      edges: float32 (n_fn, dim, n_bins + 1) current grid.
    Returns:
      float64 (n_fn, dim, n_bins) nonnegative weights.
    """
    k0, k1 = key
    device = family.device
    edges = torch.from_numpy(np.array(edges, np.float32)).to(device)
    n_bins = int(edges.shape[-1]) - 1
    fn_ids = torch.arange(family.n_fn, dtype=torch.int64, device=device)
    sample_ids = torch.arange(int(n_samples), dtype=torch.int64, device=device)
    u = rng.uniforms_for(k0, k1, fn_ids, sample_ids, family.dim)
    x, jac = apply_map(u, edges[:, None])
    d2 = torch.square(family.eval_batch(x) * jac)           # (n_fn, S)
    idx = torch.clamp((u * float(n_bins)).to(torch.int64), max=n_bins - 1)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    w = torch.stack([torch.where(idx == b, d2[..., None], zero).sum(1)
                     for b in range(n_bins)], dim=-1)        # (n_fn, dim, nb)
    return w.cpu().numpy().astype(np.float64)


def refine_edges(edges, weights, *, alpha: float = ALPHA) -> np.ndarray:
    """One VEGAS refinement: redistribute edges toward equal importance.

    Per (function, axis): smooth the binned weights with the (1, 6, 1)/8
    stencil, damp with ``((w - 1) / ln w)^alpha``, then walk the old bins
    placing new edges at equal cumulative importance.  Axes whose weights
    are degenerate (all zero or non-finite) keep their edges.  Returns
    float32 edges of the input shape, strictly increasing per axis.
    """
    edges = np.asarray(edges, np.float64)
    weights = np.asarray(weights, np.float64)
    if weights.shape[:-1] != edges.shape[:-1] or \
            weights.shape[-1] != edges.shape[-1] - 1:
        raise ValueError(f"weights {weights.shape} do not match edges "
                         f"{edges.shape}")
    out = np.array(edges, copy=True)
    n_fn, dim = edges.shape[0], edges.shape[1]
    for f in range(n_fn):
        for d in range(dim):
            out[f, d] = _refine_axis(edges[f, d], weights[f, d], alpha)
    return out.astype(np.float32)


def _refine_axis(e, w, alpha: float) -> np.ndarray:
    n_bins = w.shape[0]
    if not np.all(np.isfinite(w)) or w.sum() <= 0.0 or n_bins < 2:
        return e
    s = np.empty_like(w)
    s[0] = (7.0 * w[0] + w[1]) / 8.0
    s[-1] = (w[-2] + 7.0 * w[-1]) / 8.0
    if n_bins > 2:
        s[1:-1] = (w[:-2] + 6.0 * w[1:-1] + w[2:]) / 8.0
    s = s / s.sum()
    # Lepage compression: r -> ((s - 1)/ln s)^alpha in (0, 1), monotone
    # in s; the limit at s -> 1 is 1.
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(s > 0.0, ((s - 1.0) / np.log(s)) ** alpha, 0.0)
    r = np.where(np.abs(s - 1.0) < 1e-12, 1.0, r)
    r = np.maximum(r, r.sum() * _MIN_IMPORTANCE / n_bins)
    per = r.sum() / n_bins
    new = np.array(e, copy=True)
    j = 0
    acc = 0.0
    for i in range(1, n_bins):
        target = per * i
        while j < n_bins - 1 and acc + r[j] < target:
            acc += r[j]
            j += 1
        frac = (target - acc) / r[j]
        new[i] = e[j] + frac * (e[j + 1] - e[j])
    return new


def region_scores(fn, domain, key, *, splits_per_dim: int = 2,
                  n_per: int = 256, device=None):
    """Coarse per-region variance scan (the stratified seed heuristic).

    A uniform stratified scan (:func:`stratified.initial_grid` /
    :func:`stratified.eval_strata`) whose per-stratum ``volume *
    sqrt(variance)`` scores are the priorities
    :func:`repro_torch.core.tree_search.refine` splits on.

    Args:
      fn: one integrand, (..., dim) -> (...).
      domain: (dim, 2) finite box.
      key: (k0, k1) counter key pair.
      device: ``"cuda"`` (default; raises without a GPU) or ``"cpu"``.
    Returns:
      ``(boxes, scores)``: (n_strata, dim, 2) stratum boxes and their
      float32 priority scores, as numpy arrays.
    """
    domain = np.asarray(domain, np.float32)
    n_strata = int(splits_per_dim) ** domain.shape[0]
    table = stratified.initial_grid(domain, int(splits_per_dim), n_strata,
                                    device=resolve_device(device))
    slots = torch.arange(n_strata, dtype=torch.int64, device=table.boxes.device)
    _, var = stratified.eval_strata(fn, table.boxes, slots, 0, int(n_per), key)
    vol = stratified.stratum_volumes(table)
    return (table.boxes.cpu().numpy(),
            (vol * torch.sqrt(var)).cpu().numpy())
