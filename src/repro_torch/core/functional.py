"""``ZMCFunctional`` — parameter-scan integration, the v5 feature
(PyTorch port of ``repro.core.functional``).

One integrand over a grid of parameter vectors:
``I(theta_j) = Int f(x; theta_j) dx`` for j = 1..n_param.  That is one
:class:`IntegrandFamily` whose functions are the parameter points, so the
class is a thin wrapper over the multi-function solver, which is how
v5.1 subsumes v5 in the paper.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.integrand import MultiFunctionSpec, family_from_numpy
from repro_torch.core.multifunctions import (MultiFunctionResult,
                                             ZMCMultiFunctions)
from repro_torch.core.tree import tree_leaves, tree_map


class ZMCFunctional:
    """Scan a parameter grid of one integrand.

    Args:
      fn: batched ``fn(x, theta) -> values``: ``x`` is (n_param, B, dim),
        ``theta`` the parameter dict with leading axis ``n_param``, the
        result (n_param, B) (the port's convention for a family's ``fn``).
      param_grid: dict (nested dicts allowed) of arrays or tensors, each
        with leading axis ``n_param``.
      domain: (dim, 2) integration box shared by every point (may contain
        inf: the solver compactifies it).
      mesh, device: as for :class:`ZMCMultiFunctions` (default device
        ``"cuda"``).
    """

    def __init__(
        self,
        fn: Callable[[torch.Tensor, dict], torch.Tensor],
        param_grid: dict,
        domain,
        n_samples: int = 10**5,
        seed: int = 0,
        *,
        mesh=None,
        chunk: int = 8192,
        fn_chunk: int | None = None,
        use_kernel: bool = False,
        name: str = "functional",
        device=None,
    ):
        domain = np.asarray(domain, np.float32)
        if domain.ndim != 2 or domain.shape[-1] != 2:
            raise ValueError(f"domain must be (dim, 2); got {domain.shape}")
        leaves = tree_leaves(param_grid)
        if not leaves:
            raise ValueError("param_grid must have at least one leaf")
        n_param = int(np.shape(leaves[0])[0])
        family = family_from_numpy(
            None, tree_map(lambda v: v.detach().cpu().numpy()
                           if isinstance(v, torch.Tensor) else np.asarray(v),
                           param_grid),
            np.broadcast_to(domain, (n_param,) + domain.shape), name, fn=fn)
        self._engine = ZMCMultiFunctions(
            MultiFunctionSpec.from_families([family]), n_samples=n_samples,
            seed=seed, mesh=mesh, chunk=chunk, fn_chunk=fn_chunk,
            use_kernel=use_kernel, device=device)
        self.n_param = n_param

    def evaluate(self, num_trials: int = 1) -> MultiFunctionResult:
        return self._engine.evaluate(num_trials=num_trials)

    def evaluate_resumable(self, **kw) -> MultiFunctionResult:
        return self._engine.evaluate_resumable(**kw)
