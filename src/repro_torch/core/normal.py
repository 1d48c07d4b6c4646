"""``ZMCNormal`` — stratified sampling + heuristic tree search (v1–v3
API; PyTorch port of ``repro.core.normal``).

For single high-dimensional integrands (the paper recommends it for
dimensionality 8–12).  Wraps :mod:`repro_torch.core.tree_search` with
the original package's trial semantics: ``evaluate()`` runs
``num_trials`` independent refinements, trial ``t`` keyed by
``rng.fold_key(seed, t)``, and reports their mean and spread.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core import rng, tree_search
from repro_torch.device import resolve_device


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
      mesh: not ported yet; raises.
      device: ``"cuda"`` (default; raises without a GPU) or ``"cpu"``.
    """

    def __init__(self, fn: Callable, domain, seed: int = 0, *,
                 splits_per_dim: int = 3, n_per_stratum: int = 2048,
                 depth: int = 8, k_split: int = 32, mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= is not ported yet (ROADMAP queue 1 item 11: "
                "multi-device on torch.distributed)")
        self.fn = fn
        self.domain = np.asarray(domain, np.float32)
        if not np.all(np.isfinite(self.domain)):
            raise ValueError(
                "ZMCNormal requires a finite box; compactify the integrand "
                "first (see repro_torch.core.domains.compactify)")
        self.device = resolve_device(device)
        self.seed = seed
        self.opts = dict(splits_per_dim=splits_per_dim, n_per=n_per_stratum,
                         depth=depth, k_split=k_split)

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
