"""Stratified sampling primitives (PyTorch port of
``repro.core.stratified``, the ``ZMCintegral_normal`` substrate).

The domain is partitioned into axis-aligned boxes ("strata"); each is
estimated with a fixed sample budget and the estimates are combined.
The per-stratum variance drives the tree search in
:mod:`repro_torch.core.tree_search`, and the same ``vol * sqrt(var)``
scores grade an integrand in :func:`repro_torch.core.adaptive
.region_scores`.

The table has a fixed capacity with an active mask, as ``repro``'s.  With
``use_kernel=True`` the per-stratum reduction goes through
:func:`repro_torch.kernels.moments.ops.stratum_moments` (the CUDA kernel
on the card, its plain version on the CPU).

On a mesh, :func:`eval_strata` splits every stratum's samples over all
the mesh's ranks (``repro`` only annotates a sharding of the samples): each rank draws its
slice by the same counters, and the per-rank (count, mean, M2) are merged
in rank order by the Chan/Welford rule, so every rank holds the same
table.
"""

from __future__ import annotations

import itertools
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import rng
from repro_torch.distributed import collectives

# Counter stride between refinement epochs of one stratum slot.
EPOCH_STRIDE = 1 << 16


class StratumTable(NamedTuple):
    """Fixed-capacity pool of strata plus per-stratum statistics."""
    boxes: torch.Tensor    # (cap, dim, 2)
    mean: torch.Tensor     # (cap,) per-stratum sample mean of f
    var: torch.Tensor      # (cap,) per-stratum population variance of f
    active: torch.Tensor   # (cap,) bool

    @property
    def capacity(self) -> int:
        return int(self.boxes.shape[0])

    @property
    def dim(self) -> int:
        return int(self.boxes.shape[1])


def initial_grid(domain, splits_per_dim: int, capacity: int,
                 device=None) -> StratumTable:
    """Uniform grid of ``splits_per_dim**dim`` strata, padded to capacity
    with inactive unit boxes."""
    domain = np.asarray(domain, np.float32)
    dim = domain.shape[0]
    n0 = splits_per_dim ** dim
    if n0 > capacity:
        raise ValueError(f"initial grid {n0} exceeds capacity {capacity}")
    edges = [np.linspace(domain[d, 0], domain[d, 1], splits_per_dim + 1)
             for d in range(dim)]
    boxes = np.zeros((capacity, dim, 2), np.float32)
    boxes[:, :, 1] = 1.0  # benign padding boxes
    for i, combo in enumerate(itertools.product(range(splits_per_dim),
                                                repeat=dim)):
        for d, c in enumerate(combo):
            boxes[i, d, 0] = edges[d][c]
            boxes[i, d, 1] = edges[d][c + 1]
    active = np.zeros((capacity,), bool)
    active[:n0] = True
    zeros = torch.zeros((capacity,), dtype=torch.float32, device=device)
    return StratumTable(boxes=torch.from_numpy(boxes).to(device), mean=zeros,
                        var=zeros, active=torch.from_numpy(active).to(device))


def stratum_volumes(table: StratumTable) -> torch.Tensor:
    widths = table.boxes[..., 1] - table.boxes[..., 0]
    return torch.prod(widths, dim=-1)


def stratum_ids(slot_ids, epoch: int) -> torch.Tensor:
    """Counter function ids ``slot + (epoch + 1) * 65536`` (u32 wrap) as
    int64: re-evaluating a slot in a later epoch draws fresh numbers."""
    slots = rng.as_u32(slot_ids)
    return (slots + (int(epoch) + 1) * EPOCH_STRIDE) & rng.MASK32


def eval_strata(fn: Callable, boxes: torch.Tensor, slot_ids, epoch: int,
                n_per: int, key, use_kernel: bool = False, mesh=None):
    """Sample ``n_per`` points in each box; return (mean, var) per box.

    ``fn`` maps (..., dim) -> (...).  Samples are drawn on ``boxes``'
    device.  ``use_kernel`` routes the per-stratum moments through
    ``stratum_moments`` (one pass over the values; the samples per rank
    must be a multiple of 512).  With ``mesh``, samples ``[i * n_per / P,
    (i + 1) * n_per / P)`` of every stratum are drawn by rank ``i`` of the
    mesh's ``P`` (``n_per`` must divide evenly), and the ranks' moments
    merged.
    """
    k0, k1 = key
    device = boxes.device
    ids = stratum_ids(torch.as_tensor(slot_ids).to(device), epoch)
    n_local, first = int(n_per), 0
    if mesh is not None:
        sample_axes = tuple(mesh.mesh_dim_names)
        shards = collectives.axis_size(mesh, sample_axes)
        if n_local % shards:
            raise ValueError(f"n_per={n_per} must divide evenly over the "
                             f"{shards} sample shards of the mesh")
        n_local //= shards
        first = collectives.axis_index(mesh, sample_axes) * n_local
    sample_ids = first + torch.arange(n_local, dtype=torch.int64, device=device)
    u = rng.uniforms_for(k0, k1, ids, sample_ids, boxes.shape[-2])
    lo = boxes[:, None, :, 0]
    hi = boxes[:, None, :, 1]
    vals = fn(lo + u * (hi - lo))
    if use_kernel:
        from repro_torch.kernels.moments.ops import stratum_moments
        m = stratum_moments(vals)
        mean, var = m.mean, m.m2 / torch.clamp(m.count, min=1.0)
    else:
        mean = torch.mean(vals, dim=-1)
        var = torch.clamp(torch.mean(torch.square(vals), dim=-1)
                          - torch.square(mean), min=0.0)
    if mesh is None:
        return mean, var
    return _merge_moments(collectives.gather(torch.stack([mean, var]), mesh,
                                             sample_axes), float(n_local))


def _merge_moments(parts, n_b: float):
    """Fold per-shard (mean, var) stacks of ``n_b`` samples each in order
    by the Chan/Welford rule; (mean, var) of all of them."""
    mean, var = parts[0][0], parts[0][1]
    if len(parts) == 1:
        return mean, var
    n, m2 = n_b, var * n_b
    for p in parts[1:]:
        tot = n + n_b
        delta = p[0] - mean
        mean = mean + delta * (n_b / tot)
        m2 = m2 + p[1] * n_b + torch.square(delta) * (n * n_b / tot)
        n = tot
    return mean, m2 / n


def table_estimate(table: StratumTable, n_per: int):
    """(integral, stderr) from the current per-stratum statistics."""
    vol = stratum_volumes(table)
    act = table.active.to(torch.float32)
    total = torch.sum(act * vol * table.mean)
    var = torch.sum(act * torch.square(vol) * table.var / float(n_per))
    return total, torch.sqrt(var)


def suggested_capacity(dim: int, splits_per_dim: int, depth: int,
                       k_split: int) -> int:
    return splits_per_dim ** dim + depth * k_split
