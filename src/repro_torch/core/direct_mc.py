"""Direct Monte-Carlo engine (PyTorch port of ``repro.core.direct_mc``).

For every integrand ``i`` draw ``N`` uniforms in its box and form

    mean_i   = vol_i / N * sum_s f_i(x_s)
    stderr_i = vol_i * sqrt( (E[f^2] - E[f]^2) / N )

:func:`family_sums` computes the raw sums chunked over samples (and
optionally over functions), or, with ``use_kernel=True``, through the
family's registered fused kernel (``repro_torch.kernels``).  The chunked
path serves every family, including forms no kernel serves, and is the
oracle the kernel is held against.

Counters are global: sample ``s`` of function ``i`` uses the same
Threefry counter however the work is split, so every path computes the
same sums up to f32 association order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import rng
from repro_torch.core.domains import affine_from_unit, box_volume
from repro_torch.core.integrand import IntegrandFamily
from repro_torch.core.tree import tree_map
from repro_torch.distributed import collectives


class SumsState(NamedTuple):
    """Raw accumulators; mergeable across chunks and restarts."""
    s1: torch.Tensor   # (n_fn,) sum of f
    s2: torch.Tensor   # (n_fn,) sum of f^2
    n: torch.Tensor    # scalar: samples accumulated


class MCResult(NamedTuple):
    mean: torch.Tensor    # (n_fn,) integral estimates
    stderr: torch.Tensor  # (n_fn,) standard error of the estimate
    n: torch.Tensor       # samples per function


def n_tensor(n_samples: int, device) -> torch.Tensor:
    """The f32 scalar sample count a SumsState carries."""
    return torch.tensor(float(n_samples), dtype=torch.float32, device=device)


def _eval_chunk(family: IntegrandFamily, k0, k1, fn_ids, sample_ids, valid,
                sampler: str = "mc"):
    """Evaluate one (n_fn, chunk) block of samples. Returns (s1, s2) sums."""
    if sampler == "sobol":
        from repro_torch.core import sobol
        u = sobol.sobol_uniforms_for(k0, k1, fn_ids, sample_ids, family.dim)
    else:
        u = rng.uniforms_for(k0, k1, fn_ids, sample_ids, family.dim)
    x = affine_from_unit(u, family.domains[:, None, :, :])
    vals = family.eval_batch(x)
    vals = torch.where(valid[None, :], vals, torch.zeros((), dtype=vals.dtype,
                                                         device=vals.device))
    return torch.sum(vals, dim=-1), torch.sum(torch.square(vals), dim=-1)


def family_sums(
    family: IntegrandFamily,
    n_samples: int,
    key: tuple,
    *,
    fn_offset: int = 0,
    sample_offset: int = 0,
    chunk: int = 8192,
    fn_chunk: int | None = None,
    use_kernel: bool = False,
    sampler: str = "mc",
) -> SumsState:
    """Chunked (s1, s2) sums for every function in the family.

    Args:
      n_samples: samples per function contributed by this call.
      key: (k0, k1) u32 Threefry key words.
      fn_offset: global id of this family's function 0.
      sample_offset: global index of the first sample (resume).
      chunk: samples per inner step; bounds peak memory at
        n_fn * chunk * dim floats.
      fn_chunk: optional function-axis blocking for very large families.
      use_kernel: run the family's registered fused kernel if its form
        supports (dim, sampler); anything else takes the chunked path.
      sampler: "mc" (Threefry) or "sobol" (shifted Sobol points; a family
        above ``sobol.MAX_DIM`` dims degrades to "mc").  With ``fn_chunk``
        the blocks draw MC samples whatever the sampler, as ``repro``'s do.
    """
    if sampler not in ("mc", "sobol"):
        raise ValueError(f"unknown sampler {sampler!r}")
    n_fn = family.n_fn
    if fn_chunk is not None and fn_chunk < n_fn:
        return _fn_blocked_sums(family, n_samples, key, fn_offset=fn_offset,
                                sample_offset=sample_offset, chunk=chunk,
                                fn_chunk=fn_chunk)
    fn_ids = (fn_offset + torch.arange(n_fn, dtype=torch.int64,
                                       device=family.device)) & rng.MASK32
    return _sums_with_ids(family, n_samples, key, fn_ids, sample_offset,
                          chunk, use_kernel, sampler=sampler)


def _fn_blocked_sums(family, n_samples, key, *, fn_offset, sample_offset,
                     chunk, fn_chunk) -> SumsState:
    """Loop over function blocks to bound memory for huge n_fn.  Each
    block takes the chunked MC path, as in ``repro``."""
    n_fn = family.n_fn
    n_blocks = math.ceil(n_fn / fn_chunk)
    pad = n_blocks * fn_chunk - n_fn

    def pad_leaf(leaf):
        return F.pad(leaf, [0, 0] * (leaf.ndim - 1) + [0, pad])

    params = tree_map(pad_leaf, family.params)
    domains = pad_leaf(family.domains)
    # padded rows get [0,1] boxes so volumes stay finite; results are sliced off
    if pad:
        domains[n_fn:, :, 1] = 1.0
    s1s, s2s = [], []
    for idx in range(n_blocks):
        sl = slice(idx * fn_chunk, (idx + 1) * fn_chunk)
        fam = dataclasses.replace(
            family, params=tree_map(lambda v: v[sl], params),
            domains=domains[sl])
        out = family_sums(fam, n_samples, key,
                          fn_offset=fn_offset + idx * fn_chunk,
                          sample_offset=sample_offset, chunk=chunk)
        s1s.append(out.s1)
        s2s.append(out.s2)
    return SumsState(s1=torch.cat(s1s)[:n_fn], s2=torch.cat(s2s)[:n_fn],
                     n=n_tensor(n_samples, family.device))


def finalize(family: IntegrandFamily, sums: SumsState) -> MCResult:
    """Turn raw sums into (mean, stderr) integral estimates."""
    vol = box_volume(family.domains)
    n = torch.clamp(sums.n, min=1.0)
    mean_f = sums.s1 / n
    var_f = torch.clamp(sums.s2 / n - torch.square(mean_f), min=0.0)
    return MCResult(mean=vol * mean_f, stderr=vol * torch.sqrt(var_f / n),
                    n=sums.n)


def merge_sums(a: SumsState, b: SumsState) -> SumsState:
    return SumsState(s1=a.s1 + b.s1, s2=a.s2 + b.s2, n=a.n + b.n)


def _pad_family_to(family: IntegrandFamily, n_fn_padded: int) -> IntegrandFamily:
    """``family`` with zero rows appended up to ``n_fn_padded`` functions:
    every params leaf zero-padded, padded boxes ``[0, 1]`` (a padded
    compactified row gets transform kind 0, the identity)."""
    pad = n_fn_padded - family.n_fn
    if pad == 0:
        return family

    def pad_leaf(leaf):
        return F.pad(leaf, [0, 0] * (leaf.ndim - 1) + [0, pad])

    domains = pad_leaf(family.domains)
    domains[family.n_fn:, :, 1] = 1.0
    return dataclasses.replace(family, params=tree_map(pad_leaf, family.params),
                               domains=domains)


def sharded_family_sums(family: IntegrandFamily, n_samples: int, key: tuple,
                        mesh, *, fn_axis: str = "model", sample_axes=("data",),
                        fn_offset: int = 0, sample_offset: int = 0,
                        chunk: int = 8192, use_kernel: bool = False,
                        sampler: str = "mc"):
    """Multi-device (s1, s2) sums of one family.

    Functions shard over ``fn_axis`` (the family zero-padded to a multiple
    of the shards), and each sample-axis shard draws ``ceil(n /
    shards)`` samples from its own counter window, so the call draws
    ``[sample_offset, sample_offset + ceil(n / shards) * shards)`` and
    reports that rounded total as ``n``, as ``repro`` does (the service
    keeps its rounds divisible by the shards).  The shards' sums are added
    in rank order and the rows reassembled on every rank.

    Returns ``(sums, padded_family)``; ``sums`` has the padded rows.
    """
    sample_axes = tuple(sample_axes)
    fn_par = collectives.mesh_shape(mesh)[fn_axis]
    sample_par = collectives.axis_size(mesh, sample_axes)
    n_fn_padded = math.ceil(family.n_fn / fn_par) * fn_par
    fam = _pad_family_to(family, n_fn_padded)
    per_shard = math.ceil(int(n_samples) / sample_par)
    per_fn = n_fn_padded // fn_par
    f0 = collectives.axis_index(mesh, (fn_axis,)) * per_fn
    rows = slice(f0, f0 + per_fn)
    local = dataclasses.replace(fam, params=tree_map(lambda v: v[rows], fam.params),
                                domains=fam.domains[rows])
    fn_ids = (fn_offset + f0 + torch.arange(per_fn, dtype=torch.int64,
                                            device=fam.device)) & rng.MASK32
    shard_offset = (int(sample_offset)
                    + collectives.axis_index(mesh, sample_axes) * per_shard) & rng.MASK32
    part = _sums_with_ids(local, per_shard, key, fn_ids, shard_offset, chunk,
                          use_kernel, sampler=sampler)
    sums = collectives.psum_gather_rows(torch.stack([part.s1, part.s2], dim=-1),
                                        mesh, sample_axes, fn_axis)
    return SumsState(s1=sums[:, 0], s2=sums[:, 1],
                     n=n_tensor(per_shard * sample_par, fam.device)), fam


def _sums_with_ids(family, n_samples, key, fn_ids, sample_offset, chunk,
                   use_kernel, sampler: str = "mc") -> SumsState:
    """Like :func:`family_sums` but with explicit fn ids (int64 tensor of
    u32 values) and sample offset.

    ``use_kernel`` dispatch is capability-checked: the registered kernel
    runs only if the family's form supports (dim, sampler) and its
    wrapper stages (compactified, swept, adapted); otherwise the chunked
    path below takes over, evaluating the family through its ``fn`` (an
    adapted family's maps its uniforms through the grid).  Sobol beyond
    ``sobol.MAX_DIM`` degrades to MC.
    """
    if sampler == "sobol":
        from repro_torch.core.sobol import MAX_DIM
        if family.dim > MAX_DIM:
            sampler = "mc"
    if use_kernel and family.kernel is not None:
        from repro_torch.kernels import registry
        impl = registry.lookup(family.kernel, dim=family.dim, sampler=sampler,
                               compactified=family.compact,
                               sweep=family.swept,
                               adapted=bool(family.adapt_bins))
        if impl is not None:
            return impl(family, n_samples, key, fn_ids=fn_ids,
                        sample_offset=sample_offset)
    k0, k1 = key
    device = family.device
    n_chunks = max(1, math.ceil(n_samples / chunk))
    lane = torch.arange(chunk, dtype=torch.int64, device=device)
    s1 = torch.zeros(family.n_fn, dtype=torch.float32, device=device)
    s2 = torch.zeros_like(s1)
    for i in range(n_chunks):
        sample_ids = (sample_offset + i * chunk + lane) & rng.MASK32
        valid = (i * chunk + lane) < n_samples
        c1, c2 = _eval_chunk(family, k0, k1, fn_ids, sample_ids, valid,
                             sampler=sampler)
        s1 = s1 + c1
        s2 = s2 + c2
    return SumsState(s1=s1, s2=s2, n=n_tensor(n_samples, device))
