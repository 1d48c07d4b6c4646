"""Fused multi-family dispatch: one launch per (dim, sampler) bucket
(port of ``repro.kernels.mc_eval.multi``, single device, one round).

1. every family whose ``kernel`` names a registered form supporting
   (dim, sampler) is **fusable**; the rest are left to the chunked path
   (``FusionPlan.unfused``, the caller handles them);
2. fusable families are bucketed by dimension;
3. within a bucket each family is padded to an ``F_BLK`` multiple (so
   every function block is homogeneous in form), packed parameters are
   padded to the bucket's widest form and everything is concatenated;
4. the whole bucket runs in one :func:`template.fused_mc` launch, each
   block's body picked by its form id (``_Bucket.block_forms``);
5. results are sliced back out per family.

The plan depends only on the spec, so callers build it once and re-run
it per trial with other keys and offsets.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import rng
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
    slices: tuple[_Slice, ...]
    name: str


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    buckets: tuple[_Bucket, ...]
    unfused: tuple[int, ...]   # family indices left to the chunked path
    sampler: str

    @property
    def n_launches(self) -> int:
        return len(self.buckets)


def plan_spec(spec, *, sampler: str = "mc", fn_offsets=None) -> FusionPlan:
    """Bucket a MultiFunctionSpec's fusable families by dimension.

    Bucket tensors live on the families' device.

    Args:
      spec: ``repro_torch.core.integrand.MultiFunctionSpec``.
      sampler: a family fuses only if its form supports this sampler.
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
        if form is None or not form.supports(dim=fam.dim, sampler=sampler):
            unfused.append(idx)
            continue
        by_dim.setdefault(fam.dim, []).append(idx)

    buckets = []
    for dim in sorted(by_dim):
        idxs = by_dim[dim]
        packed_parts, lo_parts, hi_parts, id_parts = [], [], [], []
        block_forms: list[int] = []
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
            slices.append(_Slice(idx, row, n_fn))
            row += n_fn_pad

        buckets.append(_Bucket(
            dim=dim,
            packed=torch.cat(packed_parts).contiguous(),
            lo=torch.cat(lo_parts).contiguous(),
            hi=torch.cat(hi_parts).contiguous(),
            fn_ids=torch.cat(id_parts),
            block_forms=torch.from_numpy(np.asarray(block_forms, np.int32)),
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

    if plan.sampler != "mc":
        raise NotImplementedError(
            "sampler='sobol' is not ported yet (ROADMAP queue 1 item 7)")
    n_sample_blocks = max(1, math.ceil(int(n_samples) / S_BLK))
    scalars = template.pack_scalars(key, sample_offset, n_samples)

    out: dict[int, SumsState] = {}
    for bucket in plan.buckets:
        sums = template.fused_mc(
            scalars, bucket.fn_ids, bucket.packed, bucket.lo, bucket.hi,
            bucket.block_forms, dim=bucket.dim,
            n_sample_blocks=n_sample_blocks)[0]
        n = n_tensor(n_samples, sums.device)
        for sl in bucket.slices:
            rows = sums[sl.row_start:sl.row_start + sl.n_fn]
            out[sl.family_index] = SumsState(s1=rows[:, 0], s2=rows[:, 1], n=n)
    return out
