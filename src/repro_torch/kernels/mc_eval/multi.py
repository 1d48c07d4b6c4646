"""Fused multi-family dispatch: one launch per (dim, sampler) bucket
(port of ``repro.kernels.mc_eval.multi``).

1. every family whose ``kernel`` names a registered form supporting
   (dim, sampler) and its wrapper stages is **fusable**, compactified
   infinite-domain families (their transform columns ride after the
   form's), swept families (one row per grid point, their table
   columns after the base columns) and adapted families (their grid
   edges before the transform columns) included; the rest are left to the
   chunked path (``FusionPlan.unfused``, the caller handles them), among
   them Sobol families above ``core.sobol.MAX_DIM`` dims;
2. fusable families are bucketed by dimension;
3. within a bucket each family is padded to an ``F_BLK`` multiple (so
   every function block is homogeneous in form), packed parameters are
   padded to the bucket's widest form and everything is concatenated;
4. the whole bucket runs in one :func:`template.fused_mc` launch with
   the plan's sampler, each block's body picked by its form id
   (``_Bucket.block_forms``), wrapped in the compactification stage
   where ``_Bucket.block_tcols`` names its transform columns, in the
   importance-grid stage where ``_Bucket.block_adapt`` names its grid
   edges, and run on its packed rows with the table columns of
   ``_Bucket.block_sweep`` substituted in a swept block; adapted and
   unadapted families of one dim share a bucket;
5. results are sliced back out per family.

The plan depends only on the spec, so callers build it once and re-run
it per trial with other keys and offsets.

Multi-round plans: :func:`launch_plan_rounds` (the port of ``repro``'s
``eval_plan_rounds``) evaluates R consecutive fixed-size counter rounds
of every bucket in ONE launch each, so a service wave of R rounds over B
buckets costs B launches.  Per-family start rounds become per-block
``round_base`` window starts, so streams at different depths share a
launch; each round's sums are bit-identical to the single-round launch
at that offset.  It returns each launch's ``[R, F, 2]`` output whole, so
the caller copies it to the host once and slices it there.

On a mesh (:func:`sharded_eval_plan`, :func:`sharded_eval_plan_rounds`)
each rank launches the same kernel once per bucket on its slice of the
bucket's function blocks (``fn_axis``) and its window of the samples
(the other axes), and :func:`repro_torch.distributed.collectives
.psum_gather_rows` sums the windows in rank order and reassembles the
rows, so every rank ends with the whole bucket's sums, the same bits on
every rank.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import rng
from repro_torch.distributed import collectives
from repro_torch.kernels import registry, template
from repro_torch.kernels.template import F_BLK, S_BLK


@dataclasses.dataclass(frozen=True)
class _Slice:
    """Where one family's functions live inside a bucket's padded rows."""
    family_index: int
    row_start: int
    n_fn: int


@dataclasses.dataclass(frozen=True)
class _Bucket:
    """One fused launch: all same-dim fusable families, concatenated."""
    dim: int
    packed: torch.Tensor          # f32[n_fn_pad, n_cols_max]
    lo: torch.Tensor              # f32[n_fn_pad, dim]
    hi: torch.Tensor              # f32[n_fn_pad, dim]
    fn_ids: torch.Tensor          # int64 u32[n_fn_pad] global function ids
    block_forms: torch.Tensor     # i32[n_fn_pad // F_BLK] kernel form ids (CPU)
    block_tcols: torch.Tensor     # i32[n_fn_pad // F_BLK] first transform col or -1 (CPU)
    block_sweep: torch.Tensor | None  # i32[2 * S, n_fn_pad // F_BLK] sweep pairs (CPU)
    block_adapt: torch.Tensor     # i32[2, n_fn_pad // F_BLK] first grid col or -1, n_bins (CPU)
    block_meta: torch.Tensor      # i32[4 + 2 * S, n_fn_pad // F_BLK]: all four, on the device
    dirvecs: torch.Tensor | None  # i32[dim, 32] Sobol direction vectors on the device (sobol plans)
    slices: tuple[_Slice, ...]
    name: str


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    buckets: tuple[_Bucket, ...]
    unfused: tuple[int, ...]   # family indices left to the chunked path
    sampler: str
    # (fn shards, this rank's fn index) -> its _RankBucket per bucket
    shards: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def n_launches(self) -> int:
        return len(self.buckets)


def plan_spec(spec, *, sampler: str = "mc", fn_offsets=None) -> FusionPlan:
    """Bucket a MultiFunctionSpec's fusable families by dimension.

    Bucket tensors live on the families' device; the per-block form ids,
    transform columns, sweep pairs and grid columns are also kept on the
    CPU (``block_forms``, ``block_tcols``, ``block_sweep``, None in a
    bucket without a swept family, and ``block_adapt``) for the checks
    and the plain version.

    Args:
      spec: ``repro_torch.core.integrand.MultiFunctionSpec``.
      sampler: "mc" or "sobol"; a family fuses only if its form supports
        this sampler at its dim.
      fn_offsets: optional per-family global fn-id offsets (defaults to
        ``spec.offsets()``, the engine's counter layout).
    """
    families = spec.families
    if fn_offsets is None:
        fn_offsets = spec.offsets()

    by_dim: dict[int, list[int]] = {}
    unfused: list[int] = []
    for idx, fam in enumerate(families):
        form = registry.form(fam.kernel) if fam.kernel else None
        if form is None or not form.supports(dim=fam.dim, sampler=sampler,
                                             compactified=fam.compact,
                                             sweep=fam.swept,
                                             adapted=bool(fam.adapt_bins)):
            unfused.append(idx)
            continue
        by_dim.setdefault(fam.dim, []).append(idx)

    buckets = []
    for dim in sorted(by_dim):
        idxs = by_dim[dim]
        packed_parts, lo_parts, hi_parts, id_parts = [], [], [], []
        block_forms: list[int] = []
        block_tcols: list[int] = []
        block_pairs: list[tuple] = []
        block_grids: list[tuple[int, int]] = []
        slices: list[_Slice] = []
        n_cols = max(template.packed_cols(registry.form(families[i].kernel),
                                          families[i]) for i in idxs)
        row = 0
        for idx in idxs:
            fam = families[idx]
            form = registry.form(fam.kernel)
            _, packed = template.body_and_packed(form, fam)

            n_fn = fam.n_fn
            n_fn_pad = math.ceil(n_fn / F_BLK) * F_BLK
            pad = n_fn_pad - n_fn
            packed = template.pad_rows(packed, pad)
            packed = F.pad(packed, [0, n_cols - packed.shape[1]])
            packed_parts.append(packed)
            lo_parts.append(template.pad_rows(fam.domains[..., 0], pad))
            hi_parts.append(template.pad_rows(fam.domains[..., 1], pad))
            id_parts.append(template.pad_rows(
                (fn_offsets[idx] + torch.arange(n_fn, dtype=torch.int64,
                                                device=fam.device))
                & rng.MASK32, pad))
            block_forms += [form.form_id] * (n_fn_pad // F_BLK)
            block_tcols += ([template.transform_col(form, fam)]
                            * (n_fn_pad // F_BLK))
            block_pairs += [template.sweep_pairs(form, fam)] * (n_fn_pad // F_BLK)
            block_grids += [template.adapt_col(form, fam)] * (n_fn_pad // F_BLK)
            slices.append(_Slice(idx, row, n_fn))
            row += n_fn_pad

        forms = torch.from_numpy(np.asarray(block_forms, np.int32))
        tcols = torch.from_numpy(np.asarray(block_tcols, np.int32))
        sweep = (template.block_sweep_tensor(block_pairs)
                 if any(block_pairs) else None)
        adapt = template.block_adapt_tensor(block_grids)
        packed = torch.cat(packed_parts).contiguous()
        buckets.append(_Bucket(
            dim=dim,
            packed=packed,
            lo=torch.cat(lo_parts).contiguous(),
            hi=torch.cat(hi_parts).contiguous(),
            fn_ids=torch.cat(id_parts),
            block_forms=forms,
            block_tcols=tcols,
            block_sweep=sweep,
            block_adapt=adapt,
            block_meta=template.to_card(
                template.block_meta_host(forms, tcols, sweep, adapt),
                packed.device),
            dirvecs=(template.to_card(template.sobol_dirvecs(dim), packed.device)
                     if sampler == "sobol" else None),
            slices=tuple(slices),
            name=f"mc_eval_fused_{sampler}_d{dim}f{row}c{n_cols}",
        ))
    return FusionPlan(buckets=tuple(buckets), unfused=tuple(unfused),
                      sampler=sampler)


def eval_plan(plan: FusionPlan, n_samples: int, key, *, sample_offset=0):
    """Run every bucket of a plan; returns {family_index: SumsState}.

    Family ``i``'s sums are those of
    ``family_sums(families[i], ..., use_kernel=True)`` up to f32
    association order: the counters depend only on (fn id, sample id).
    """
    from repro_torch.core.direct_mc import SumsState, n_tensor

    n_sample_blocks = max(1, math.ceil(int(n_samples) / S_BLK))
    scalars = template.pack_scalars(key, sample_offset, n_samples)

    out: dict[int, SumsState] = {}
    for bucket in plan.buckets:
        sums = template.fused_mc(
            scalars, bucket.fn_ids, bucket.packed, bucket.lo, bucket.hi,
            bucket.block_forms, dim=bucket.dim,
            n_sample_blocks=n_sample_blocks, block_tcols=bucket.block_tcols,
            block_sweep=bucket.block_sweep, block_adapt=bucket.block_adapt,
            sampler=plan.sampler, block_meta=bucket.block_meta,
            dirvecs=bucket.dirvecs)[0]
        n = n_tensor(n_samples, sums.device)
        for sl in bucket.slices:
            rows = sums[sl.row_start:sl.row_start + sl.n_fn]
            out[sl.family_index] = SumsState(s1=rows[:, 0], s2=rows[:, 1], n=n)
    return out


def _round_base_for(bucket: _Bucket, start_rounds, round_samples: int):
    """u32 per-function-block window starts for a multi-round launch, as
    an int64 CPU tensor.

    ``start_rounds`` maps family_index -> absolute index of the first
    round this launch evaluates for that family.  Blocks are per-family
    by construction (families are padded to F_BLK multiples), so the
    per-block value is exact.  Counters are u32: streams wrap at 2^32
    samples, exactly like the scalar sample_offset path.
    """
    base = torch.zeros(bucket.fn_ids.shape[0] // F_BLK, dtype=torch.int64)
    for sl in bucket.slices:
        b0 = sl.row_start // F_BLK
        nb = math.ceil(sl.n_fn / F_BLK)
        start = int(start_rounds[sl.family_index]) * int(round_samples)
        base[b0:b0 + nb] = start & rng.MASK32
    return base


def launch_plan_rounds(plan: FusionPlan, round_samples: int, n_rounds: int,
                       key, *, start_rounds):
    """R consecutive fixed-size rounds of every bucket, ONE launch each.

    Args:
      round_samples: samples per round (every round is full-size; the
        service cache's round quantum).
      n_rounds: consecutive rounds to evaluate per family.
      start_rounds: family_index -> absolute first round index; families
        may start at different depths (fused top-ups).
    Returns:
      ``({family_index: (bucket index, row_start, n_fn)}, outputs)``:
      ``outputs[b]`` is bucket ``b``'s f32[n_rounds, n_fn_pad, 2] launch
      output, left on the launch's device, and a family's round ``r``
      sums are ``outputs[b][r, row_start:row_start + n_fn]``, each
      bit-identical to the single-round :func:`eval_plan` call at
      ``sample_offset = round * round_samples``.  The caller copies each
      output to the host once and slices there (the service does), rather
      than paying a device copy per (family, round).
    """
    n_sample_blocks = max(1, math.ceil(int(round_samples) / S_BLK))
    scalars = template.pack_scalars(key, 0, round_samples,
                                    round_stride=round_samples)
    where: dict[int, tuple[int, int, int]] = {}
    outputs = []
    for b, bucket in enumerate(plan.buckets):
        outputs.append(template.fused_mc(
            scalars, bucket.fn_ids, bucket.packed, bucket.lo, bucket.hi,
            bucket.block_forms, dim=bucket.dim,
            n_sample_blocks=n_sample_blocks, n_rounds=int(n_rounds),
            round_base=_round_base_for(bucket, start_rounds, round_samples),
            block_tcols=bucket.block_tcols, block_sweep=bucket.block_sweep,
            block_adapt=bucket.block_adapt, sampler=plan.sampler,
            block_meta=bucket.block_meta, dirvecs=bucket.dirvecs))
        for sl in bucket.slices:
            where[sl.family_index] = (b, sl.row_start, sl.n_fn)
    return where, outputs


# -- the mesh ---------------------------------------------------------------------

def _shard_bucket(bucket: _Bucket, fn_par: int) -> _Bucket:
    """Pad a bucket so its ``F_BLK`` blocks divide evenly over ``fn_par``.

    Every per-block array is padded alike, so each block's metadata stays
    beside its packed rows: a padded block has the bucket's first form
    (``repro``'s body index 0, whose base columns every row of the bucket
    holds), no transform column, no sweep pair and no grid, and zero rows
    (sliced off by the caller, as the per-family padding is).
    """
    blocks = bucket.fn_ids.shape[0] // F_BLK
    extra = math.ceil(blocks / fn_par) * fn_par - blocks
    if extra == 0:
        return bucket
    rows = extra * F_BLK
    forms = torch.cat([bucket.block_forms, bucket.block_forms[:1].repeat(extra)])
    tcols = torch.cat([bucket.block_tcols, torch.full((extra,), -1, dtype=torch.int32)])
    sweep = (None if bucket.block_sweep is None
             else F.pad(bucket.block_sweep, [0, extra], value=-1))
    adapt = torch.cat([bucket.block_adapt,
                       template.block_adapt_tensor([(-1, 0)] * extra)], dim=1)
    packed = template.pad_rows(bucket.packed, rows)
    return dataclasses.replace(
        bucket, packed=packed, lo=template.pad_rows(bucket.lo, rows),
        hi=template.pad_rows(bucket.hi, rows),
        fn_ids=template.pad_rows(bucket.fn_ids, rows), block_forms=forms,
        block_tcols=tcols, block_sweep=sweep, block_adapt=adapt,
        block_meta=template.to_card(
            template.block_meta_host(forms, tcols, sweep, adapt), packed.device))


@dataclasses.dataclass(frozen=True)
class _RankBucket:
    """One rank's part of a bucket: the bucket padded for the mesh, its
    blocks ``[b0, b1)`` and the launch operands of those blocks."""
    padded: _Bucket
    b0: int
    b1: int
    local: _Bucket


def _rank_buckets(plan: FusionPlan, mesh, fn_axis: str) -> tuple[_RankBucket, ...]:
    """This rank's fn slice of every bucket (built once per plan and
    (fn shards, fn index))."""
    fn_par = collectives.mesh_shape(mesh)[fn_axis]
    fn_idx = collectives.axis_index(mesh, (fn_axis,))
    cached = plan.shards.get((fn_par, fn_idx))
    if cached is not None:
        return cached
    out = []
    for bucket in plan.buckets:
        sb = _shard_bucket(bucket, fn_par)
        per = sb.fn_ids.shape[0] // F_BLK // fn_par
        b0, b1 = fn_idx * per, (fn_idx + 1) * per
        rows = slice(b0 * F_BLK, b1 * F_BLK)
        out.append(_RankBucket(sb, b0, b1, dataclasses.replace(
            sb, packed=sb.packed[rows], lo=sb.lo[rows], hi=sb.hi[rows],
            fn_ids=sb.fn_ids[rows], block_forms=sb.block_forms[b0:b1],
            block_tcols=sb.block_tcols[b0:b1],
            block_sweep=(None if sb.block_sweep is None
                         else sb.block_sweep[:, b0:b1].contiguous()),
            block_adapt=sb.block_adapt[:, b0:b1].contiguous(),
            block_meta=sb.block_meta[:, b0:b1].contiguous(), slices=())))
    plan.shards[(fn_par, fn_idx)] = out = tuple(out)
    return out


def _sample_window(mesh, sample_axes, n_samples: int) -> tuple[int, int, int]:
    """(per_shard, start, n_local) of this rank's samples: an exact split,
    the last shards masking the tail (``n_local`` may be 0 when
    ``n_samples`` is below the shard count)."""
    per_shard = math.ceil(int(n_samples) / collectives.axis_size(mesh, sample_axes))
    start = min(collectives.axis_index(mesh, sample_axes) * per_shard, int(n_samples))
    return per_shard, start, min(int(n_samples) - start, per_shard)


def _launch_local(rb: _RankBucket, scalars, n_sample_blocks: int, sampler: str,
                  **kw) -> torch.Tensor:
    b = rb.local
    return template.fused_mc(
        scalars, b.fn_ids, b.packed, b.lo, b.hi, b.block_forms, dim=b.dim,
        n_sample_blocks=n_sample_blocks, block_tcols=b.block_tcols,
        block_sweep=b.block_sweep, block_adapt=b.block_adapt, sampler=sampler,
        block_meta=b.block_meta, dirvecs=b.dirvecs, **kw)


def sharded_eval_plan(plan: FusionPlan, n_samples: int, key, mesh, *,
                      fn_axis: str = "model", sample_axes=("data",),
                      sample_offset=0):
    """Mesh variant of :func:`eval_plan`: one fused launch per bucket on
    every rank.

    Function blocks shard over ``fn_axis`` (the bucket padded to a
    multiple of the shards); the sample-axis shards draw disjoint counter
    windows, ``ceil(n / shards)`` each, the last ones masking the tail, so
    the call draws exactly ``[sample_offset, sample_offset + n)``: the
    service's consecutive windows never overlap.  The windows' sums are
    added in rank order.  Returns {family_index: SumsState}, ``n`` exactly
    ``n_samples``, the same bits on every rank.
    """
    from repro_torch.core.direct_mc import SumsState, n_tensor

    sample_axes = tuple(sample_axes)
    per_shard, start, n_local = _sample_window(mesh, sample_axes, n_samples)
    n_sample_blocks = max(1, math.ceil(per_shard / S_BLK))
    scalars = template.pack_scalars(key, int(sample_offset) + start, n_local)
    out: dict[int, SumsState] = {}
    for bucket, rb in zip(plan.buckets, _rank_buckets(plan, mesh, fn_axis)):
        part = _launch_local(rb, scalars, n_sample_blocks, plan.sampler)[0]
        sums = collectives.psum_gather_rows(part, mesh, sample_axes, fn_axis)
        n = n_tensor(n_samples, sums.device)
        for sl in bucket.slices:
            rows = sums[sl.row_start:sl.row_start + sl.n_fn]
            out[sl.family_index] = SumsState(s1=rows[:, 0], s2=rows[:, 1], n=n)
    return out


def sharded_eval_plan_rounds(plan: FusionPlan, round_samples: int, n_rounds: int,
                             key, mesh, *, start_rounds, fn_axis: str = "model",
                             sample_axes=("data",)):
    """Mesh variant of :func:`launch_plan_rounds`: R rounds x B buckets in
    B launches per rank.

    Every rank evaluates its window of every round (the split of
    :func:`sharded_eval_plan`, each round drawing exactly
    ``round_samples`` counters in all), its fn slice of each bucket, with
    the window starts of ``start_rounds``; the ``[R, F, 2]`` stacks are
    added in rank order and their rows reassembled.  Returns what
    :func:`launch_plan_rounds` returns; each round's sums are the bits of
    the single-round :func:`sharded_eval_plan` call at that round's
    offset (the same per-rank counters and fold, and the sum across ranks
    is elementwise in a fixed order, whatever R).
    """
    sample_axes = tuple(sample_axes)
    per_shard, start, n_local = _sample_window(mesh, sample_axes, round_samples)
    n_sample_blocks = max(1, math.ceil(per_shard / S_BLK))
    scalars = template.pack_scalars(key, start, n_local, round_stride=round_samples)
    where: dict[int, tuple[int, int, int]] = {}
    outputs = []
    for b, (bucket, rb) in enumerate(zip(plan.buckets,
                                         _rank_buckets(plan, mesh, fn_axis))):
        base = _round_base_for(rb.padded, start_rounds, round_samples)[rb.b0:rb.b1]
        part = _launch_local(rb, scalars, n_sample_blocks, plan.sampler,
                             n_rounds=int(n_rounds), round_base=base)
        outputs.append(collectives.psum_gather_rows(part, mesh, sample_axes,
                                                    fn_axis, dim=1))
        for sl in bucket.slices:
            where[sl.family_index] = (b, sl.row_start, sl.n_fn)
    return where, outputs
