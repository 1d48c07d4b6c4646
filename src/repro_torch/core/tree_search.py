"""Heuristic tree search: adaptive stratum refinement (PyTorch port of
``repro.core.tree_search``, ``ZMCintegral_normal``).

Spend samples where ``vol x sigma`` is largest, on a fixed-capacity
stratum table:

  repeat ``depth`` times:
    1. priority_k = vol_k * sqrt(var_k)          (active strata only)
    2. pick the top ``k_split`` strata
    3. bisect each along its widest dimension
    4. evaluate the 2 * k_split children (a fresh counter epoch)

Each iteration evaluates only the new strata, so the work is
``n0 + 2 * depth * k_split`` stratum evaluations.  Where ``repro`` runs
the loop as a ``fori_loop``, the port runs a Python loop with
``torch.topk``.  Near-tied priorities may be ordered otherwise than
``jax.lax.top_k`` orders them, and then the two trees part.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import stratified
from repro_torch.device import resolve_device


class TreeSearchResult(NamedTuple):
    integral: torch.Tensor
    stderr: torch.Tensor
    table: stratified.StratumTable
    n_evals: int   # total integrand evaluations spent


def refine_step(fn: Callable, tab: stratified.StratumTable, key, it: int, *,
                n0: int, n_per: int, k_split: int,
                **eval_opts) -> stratified.StratumTable:
    """Refinement iteration ``it``: split the top ``k_split`` strata and
    evaluate their children at counter epoch ``it + 2`` (``eval_opts``:
    ``use_kernel`` and ``mesh`` of :func:`stratified.eval_strata`)."""
    vol = stratified.stratum_volumes(tab)
    priority = torch.where(tab.active, vol * torch.sqrt(tab.var),
                           torch.full_like(vol, -float("inf")))
    _, idx = torch.topk(priority, k_split)

    parents = tab.boxes[idx]                          # (K, dim, 2)
    lo, hi = parents[..., 0], parents[..., 1]
    widths = hi - lo
    wd = torch.argmax(widths, dim=-1)                 # widest dim per parent
    split = torch.nn.functional.one_hot(wd, tab.dim) > 0
    mid = lo + 0.5 * widths
    child_a = torch.stack([lo, torch.where(split, mid, hi)], dim=-1)
    child_b = torch.stack([torch.where(split, mid, lo), hi], dim=-1)

    slot_b = n0 + it * k_split + torch.arange(k_split, device=idx.device)
    boxes = tab.boxes.clone()
    boxes[idx] = child_a
    boxes[slot_b] = child_b
    active = tab.active.clone()
    active[slot_b] = True

    child_boxes = torch.cat([child_a, child_b])
    child_slots = torch.cat([idx, slot_b])
    # epoch it + 2: epoch 0 was the initial grid's evaluation
    mean_c, var_c = stratified.eval_strata(fn, child_boxes, child_slots,
                                           it + 2, n_per, key, **eval_opts)
    mean = tab.mean.clone()
    var = tab.var.clone()
    mean[child_slots] = mean_c
    var[child_slots] = var_c
    return stratified.StratumTable(boxes=boxes, mean=mean, var=var,
                                   active=active)


def refine(fn: Callable, table: stratified.StratumTable, key, *, n0: int,
           n_per: int, depth: int, k_split: int,
           **eval_opts) -> stratified.StratumTable:
    """Run ``depth`` refinement iterations on an initialised table."""
    for it in range(int(depth)):
        table = refine_step(fn, table, key, it, n0=n0, n_per=n_per,
                            k_split=k_split, **eval_opts)
    return table


def integrate(fn: Callable, domain, key, *, splits_per_dim: int = 3,
              n_per: int = 2048, depth: int = 8, k_split: int = 32,
              device=None, **eval_opts) -> TreeSearchResult:
    """Stratified + tree-search integration of one integrand.

    Args:
      fn: integrand mapping (..., dim) -> (...), in PyTorch.
      domain: (dim, 2) box.
      key: (k0, k1) Threefry key words.
      device: where the table lives and the samples are drawn:
        ``"cuda"`` (default; raises without a GPU) or ``"cpu"``.
      eval_opts: ``use_kernel`` and ``mesh``, passed to every
        :func:`stratified.eval_strata`; on a mesh every rank runs the same
        search on the same merged table.
    """
    domain = np.asarray(domain, np.float32)
    dim = domain.shape[0]
    n0 = splits_per_dim ** dim
    if n0 < k_split:
        raise ValueError(
            f"initial grid ({n0}) must be >= k_split ({k_split}); "
            f"raise splits_per_dim or lower k_split")
    cap = stratified.suggested_capacity(dim, splits_per_dim, depth, k_split)
    table = stratified.initial_grid(domain, splits_per_dim, cap,
                                    device=resolve_device(device))
    slots = torch.arange(n0, dtype=torch.int64, device=table.boxes.device)
    mean0, var0 = stratified.eval_strata(fn, table.boxes[:n0], slots, 0,
                                         n_per, key, **eval_opts)
    mean = table.mean.clone()
    var = table.var.clone()
    mean[:n0] = mean0
    var[:n0] = var0
    table = table._replace(mean=mean, var=var)
    table = refine(fn, table, key, n0=n0, n_per=n_per, depth=depth,
                   k_split=k_split, **eval_opts)
    integral, stderr = stratified.table_estimate(table, n_per)
    return TreeSearchResult(integral=integral, stderr=stderr, table=table,
                            n_evals=(n0 + 2 * depth * k_split) * n_per)
