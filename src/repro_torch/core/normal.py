"""``ZMCNormal`` — stratified sampling + heuristic tree search (v1–v3
API; PyTorch port of ``repro.core.normal``).

For single high-dimensional integrands (the paper recommends it for
dimensionality 8–12).  Wraps :mod:`repro_torch.core.tree_search` with
the original package's trial semantics: ``evaluate()`` runs
``num_trials`` independent refinements, trial ``t`` keyed by
``rng.fold_key(seed, t)``, and reports their mean and spread.  On a mesh
every stratum's samples split over the ranks and every rank runs
the same search (:func:`repro_torch.core.stratified.eval_strata`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core import rng, tree_search
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives


@dataclasses.dataclass
class NormalResult:
    integral: float
    stderr: float              # combined in-run stderr (mean over trials)
    trial_values: np.ndarray   # (num_trials,)

    @property
    def trial_std(self) -> float:
        if len(self.trial_values) < 2:
            return float(self.stderr)
        return float(self.trial_values.std(ddof=1))


class ZMCNormal:
    """Adaptive stratified MC for a single integrand.

    Args:
      fn: integrand mapping (..., dim) -> (...), in PyTorch.
      domain: (dim, 2) finite box.
      splits_per_dim: initial uniform grid resolution per dimension.
      n_per_stratum: samples used to estimate each stratum.
      depth: tree-search iterations.
      k_split: strata refined per iteration.
      mesh: a ``DeviceMesh``; every stratum's samples split over its
        ranks, strata are not split (as in ``repro``).
      use_kernel: the per-stratum moments through ``stratum_moments``
        (the samples per rank a multiple of 512).
      device: ``"cuda"`` (default; raises without a GPU) or ``"cpu"``; with
        ``mesh``, the rank's own.
    """

    def __init__(self, fn: Callable, domain, seed: int = 0, *,
                 splits_per_dim: int = 3, n_per_stratum: int = 2048,
                 depth: int = 8, k_split: int = 32, mesh=None,
                 use_kernel: bool = False, device=None):
        self.fn = fn
        self.domain = np.asarray(domain, np.float32)
        if not np.all(np.isfinite(self.domain)):
            raise ValueError(
                "ZMCNormal requires a finite box; compactify the integrand "
                "first (see repro_torch.core.domains.compactify)")
        self.device = (resolve_device(device) if mesh is None
                       else collectives.mesh_device(mesh, device))
        self.seed = seed
        self.opts = dict(splits_per_dim=splits_per_dim, n_per=n_per_stratum,
                         depth=depth, k_split=k_split, use_kernel=use_kernel,
                         mesh=mesh)

    def evaluate(self, num_trials: int = 5) -> NormalResult:
        vals, errs = [], []
        for t in range(num_trials):
            res = tree_search.integrate(self.fn, self.domain,
                                        rng.fold_key(self.seed, t),
                                        device=self.device, **self.opts)
            vals.append(float(res.integral))
            errs.append(float(res.stderr))
        vals = np.asarray(vals)
        return NormalResult(integral=float(vals.mean()),
                            stderr=float(np.mean(errs)), trial_values=vals)
