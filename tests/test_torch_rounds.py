"""Multi-round fused launches against repro's: the plain version's R rounds
against repro's Pallas kernel with the round axis (interpret mode, as
repro's own tests run it on the CPU) within repro's MC bound (rtol=5e-5,
atol=5e-3), each round bit-identical to a single-round launch within the
port, and the per-block window starts bit for bit, across the u32 wrap.
"""

import math

import numpy as np
import pytest
import torch

from repro.core import integrand as jint
from repro.core import rng as jrng
from repro.kernels import template as jtemplate
from repro.kernels.mc_eval import multi as jmulti
from repro_torch.core import integrand
from repro_torch.kernels import template
from repro_torch.kernels.mc_eval import multi

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

RTOL, ATOL = 5e-5, 5e-3
N_ROUND = 2048                  # samples per round
R = 3
STRIDE = N_ROUND


def _port(jfam):
    return integrand.family_from_numpy(
        jfam.kernel, {k: np.asarray(v) for k, v in jfam.params.items()},
        np.asarray(jfam.domains), jfam.name)


def _jspec():
    return jint.MultiFunctionSpec.from_families([
        jint.harmonic_family(20, 2),
        jint.abs_sum_family(9, 2, np.linspace(0.5, 2.0, 9), sign_last=-1.0),
        jint.gaussian_family(5, 2),
    ])


def _spec():
    return integrand.MultiFunctionSpec.from_families(
        [_port(f) for f in _jspec().families])


# family index -> first round; the last sits just below the u32 wrap, so
# its rounds cross 2^32
START_ROUNDS = {0: 0, 1: 5, 2: (2**32 - N_ROUND - 100) // N_ROUND}


@pytest.mark.parametrize("start_rounds,round_samples", [
    (START_ROUNDS, N_ROUND),
    ({0: 3, 1: 2**31, 2: 2**22 + 1}, 4096),     # products past 2^32 wrap
])
def test_round_base_for_bit_exact(start_rounds, round_samples):
    (jb,) = jmulti.plan_spec(_jspec()).buckets
    (b,) = multi.plan_spec(_spec()).buckets
    want = np.asarray(jmulti._round_base_for(jb, start_rounds, round_samples))
    got = multi._round_base_for(b, start_rounds, round_samples)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_pack_scalars_with_round_stride_bit_exact():
    key = jrng.fold_key(4, 1)
    want = np.asarray(jtemplate.pack_scalars(key, 2**32 - 7, 4096,
                                             round_stride=4096))
    got = template.pack_scalars(key, 2**32 - 7, 4096, round_stride=4096)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.fixture(scope="module")
def round_launches():
    """One R-round launch of a 48-row, 3-form, dim-2 bucket through both
    packages, the port's single-round launches at each round's offset,
    and the port's launch_plan_rounds over the same plan."""
    (jb,) = jmulti.plan_spec(_jspec()).buckets
    plan = multi.plan_spec(_spec())
    (b,) = plan.buckets
    key = jrng.fold_key(11, 3)
    nsb = math.ceil(N_ROUND / jtemplate.S_BLK)
    want = np.asarray(jtemplate.fused_mc_pallas(
        jtemplate.pack_scalars(key, 0, N_ROUND, round_stride=STRIDE),
        jb.fn_ids, jb.packed, jb.lo, jb.hi, form_ids=jb.form_ids,
        round_base=jmulti._round_base_for(jb, START_ROUNDS, N_ROUND),
        dim=jb.dim, n_sample_blocks=nsb, bodies=jb.bodies, n_rounds=R,
        sampler="mc", interpret=True, name=f"{jb.name}_r{R}"))
    base = multi._round_base_for(b, START_ROUNDS, N_ROUND)
    ops = (b.fn_ids, b.packed, b.lo, b.hi, b.block_forms)
    got = template.fused_mc_plain(
        template.pack_scalars(key, 0, N_ROUND, round_stride=STRIDE), *ops,
        dim=b.dim, n_sample_blocks=nsb, n_rounds=R, round_base=base,
        block_tcols=b.block_tcols)
    singles = [template.fused_mc_plain(
        template.pack_scalars(key, r * STRIDE, N_ROUND), *ops, dim=b.dim,
        n_sample_blocks=nsb, round_base=base, block_tcols=b.block_tcols)[0]
        for r in range(R)]
    template.reset_launch_count()
    where, outputs = multi.launch_plan_rounds(plan, N_ROUND, R, key,
                                              start_rounds=START_ROUNDS)
    launches = template.launch_count()
    return b, want, got, singles, where, outputs, launches


def _real(b):
    return np.concatenate([np.arange(s.row_start, s.row_start + s.n_fn)
                           for s in b.slices])


def test_rounds_plain_vs_pallas(round_launches):
    b, want, got, *_ = round_launches
    assert got.shape == want.shape == (R, b.fn_ids.shape[0], 2)
    real = _real(b)
    assert np.isfinite(got.numpy()[:, real]).all()
    np.testing.assert_allclose(got.numpy()[:, real], want[:, real],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("r", range(R))
def test_round_bit_identical_to_single_round(round_launches, r):
    _, _, got, singles, *_ = round_launches
    # bit patterns: the gaussian's zero padding rows sum NaN (0/0)
    assert torch.equal(got[r].view(torch.int32), singles[r].view(torch.int32))


def test_launch_plan_rounds_one_launch_per_bucket(round_launches):
    b, _, got, _, where, outputs, launches = round_launches
    assert launches == 1 and len(outputs) == 1
    assert torch.equal(outputs[0].view(torch.int32), got.view(torch.int32))
    assert where == {s.family_index: (0, s.row_start, s.n_fn)
                     for s in b.slices}


def test_eval_plan_rounds_matches_single_round_eval_plan():
    """repro's eval_plan_rounds contract, through launch_plan_rounds (its
    port): each round's slice of a launch output equals eval_plan at
    ``sample_offset = round * round_samples``, bit for bit (the same
    counters through the same code on the same bucket shapes)."""
    plan = multi.plan_spec(_spec())
    key = jrng.fold_key(2, 2)
    starts = {0: 1, 1: 4, 2: 0}
    where, outputs = multi.launch_plan_rounds(plan, N_ROUND, 2, key,
                                              start_rounds=starts)
    for idx, start in starts.items():
        b, row, n_fn = where[idx]
        assert outputs[b].shape[0] == 2
        for r in range(2):
            one = multi.eval_plan(plan, N_ROUND, key,
                                  sample_offset=(start + r) * N_ROUND)[idx]
            assert torch.equal(outputs[b][r, row:row + n_fn, 0], one.s1)
            assert torch.equal(outputs[b][r, row:row + n_fn, 1], one.s2)


def test_plan_block_meta_holds_forms_and_tcols():
    """The plan's block metadata for the card is its host form ids and
    transform columns, stacked as int32[2, n_blocks] on the bucket's
    device."""
    for b in multi.plan_spec(_spec()).buckets:
        assert b.block_meta.dtype == torch.int32
        assert b.block_meta.device == b.packed.device
        assert torch.equal(b.block_meta[0], b.block_forms)
        assert torch.equal(b.block_meta[1], b.block_tcols)


def test_multi_round_needs_round_stride():
    (b,) = multi.plan_spec(_spec()).buckets
    with pytest.raises(ValueError, match="round_stride"):
        template.fused_mc_plain(
            template.pack_scalars((1, 2), 0, 64), b.fn_ids, b.packed, b.lo,
            b.hi, b.block_forms, dim=2, n_sample_blocks=1, n_rounds=2)
    with pytest.raises(ValueError, match="round_base"):
        template.fused_mc_plain(
            template.pack_scalars((1, 2), 0, 64, round_stride=64), b.fn_ids,
            b.packed, b.lo, b.hi, b.block_forms, dim=2, n_sample_blocks=1,
            n_rounds=2, round_base=torch.zeros(1, dtype=torch.int64))
