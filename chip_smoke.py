#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
with nvcc, checks them against their plain PyTorch versions on the card,
and drives the port's paths: ``ZMCMultiFunctions(spec,
use_kernel=True).evaluate()`` on the paper's Fig.-1 workload (1200
integrands, five forms, dims 2-4) at 10^6 samples x 10 trials, with the
MC and the Sobol sampler, the integration service
(``repro_torch.service.IntegrationEngine``, also through ``python -m
repro_torch.launch.serve_integrals``) on the launcher's default workload,
on the Fig.-1 spec served as requests (MC and Sobol) and on a full-width
parameter sweep (MC and Sobol), VEGAS-adapted families through
``evaluate`` and adaptive requests through the service, and stratified
sampling (``eval_strata(use_kernel=True)`` and ``ZMCNormal``), and the
multi-device path (a mesh of one NCCL rank, then four gloo ranks):

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels (one nvcc per source, started together);
3. holds the device Threefry (``zmc_random_bits``) bit-exact against
   ``rng.random_bits`` over 2^20 counters, across the c0 wrap;
4. plans the spec: three dim buckets, nothing left unfused;
5. at N = 65536, holds the fused kernel against ``fused_mc_plain`` on the
   card (s1, s2 within rtol=1e-4, atol=1e-2: f32 sums in another order,
   and FMA contraction in the kernel) and two kernel launches against each
   other by sha256 (the kernel reduces in a fixed order);
6. runs ``evaluate(num_trials=10)`` at N = 10^6 with the launch counters
   reset just before, checks 3 x 10 kernel launches, and the 2-sigma
   coverage of the harmonic families against ``harmonic_analytic``;
7. holds one trial's launches at N = 10^6 (the main path's grid: 62
   chunks per function, a cut last chunk) against the plain version: means
   and standard errors within 1e-2 of a standard error (the raw-sum
   tolerance of step 5 is printed beside it), times both (CUDA events), computes the kernel's
   bound from the operations one trial needs, and reads the instruction
   mix nvcc emitted for pass 1's inner loops (``cuobjdump -sass``) beside
   the main path's registers and instructions per draw and their reference
   values (96, 72.01: the dim-outer loop, 16 draws an iteration);
8. times steady-state trials and profiles one (device busy and idle
   share, host operations by time);
9. rounds: on the Fig.-1 buckets, one R = 4 launch at N = 65536 per round
   with per-block window starts at other depths, one just below 2^32 (the
   rounds cross the u32 wrap): each round's sums sha256-equal to a
   single-round launch at that offset, and within rtol=1e-4, atol=1e-2 of
   the plain version with the same rounds;
10. compactified: d2/d3/d4 buckets of Gaussians over R^d and [0, inf)^d
   mixed with finite families at N = 10^6: kernel vs plain estimates
   within the tolerance of step 7 (the kernel timed over warm launches,
   as in step 7), and 2-sigma coverage >= 0.85 of the Gaussians against
   their analytic values; then the same spec with ``sampler="sobol"``
   (``fused_mc_pass1<1, true, true>``): kernel vs plain raw sums at
   N = 65536 (rtol=1e-4, atol=1e-2) and estimates at N = 10^6 (as step
   14), ``evaluate`` (3 launches, all Sobol and compactified), the same
   coverage gate, and the kernel timed beside its bound (tan-map and
   half-line axes counted as in the MC bound);
11. the service on the launcher's defaults (64 requests, seven families
   at dims 2-4, 16384 samples in rounds of 8192, R <= 8), served
   synchronously, with the pipelined worker thread, and again after a
   restart on the first run's state dir: launches per wave <= buckets,
   no chunked fallback round, zero launches on the warm replay, and the
   three runs' served means sha256-equal; each launch of the synchronous
   run (R = 2 rounds, compactified blocks) held against the plain
   version with the same rounds, window starts and transform columns,
   round by round, within the tolerance of step 7;
12. the service at full width: the Fig.-1 spec as seven requests of 2^20
   samples in rounds of 65536 (16 rounds, R = 8: 2 waves x 3 buckets = 6
   launches), held against ``evaluate(n_samples=2^20)`` (the same
   counters) within 1e-2 of a standard error, with the wall split into
   kernel and host time;
13. the device Sobol points and shifts (``zmc_sobol``) bit-exact against
   ``core.sobol`` on 2^17 indices crossing 2^32, at every dim 1-8, and the
   points as pass 1 walks them (``zmc_sobol_walk``: 256 threads, each
   along its stride-256 run in Gray-code order) on 102400 indices whose
   runs cross 2^32;
14. Sobol on the Fig.-1 spec: kernel vs plain raw sums at N = 65536
   (rtol=1e-4, atol=1e-2), repeat launches and each round of an R = 4
   launch sha256-equal to single launches; ``evaluate(num_trials=10)``
   with ``sampler="sobol"`` at N = 10^6 (30 launches, all Sobol), 2-sigma
   coverage of the harmonics, the median MC-to-Sobol ratio of
   ``trial_std``, and the kernel timed and held against the plain version
   at N = 10^6 within the tolerance of step 7, beside its bound (each
   distinct point counted once) and its pass-1 instantiation's registers,
   resident blocks per SM and SASS instructions per draw;
15. service configuration 3, a parameter sweep: the Fig.-1 4-d harmonic
   template over a 32 x 32 (a, b) grid (16 canonical slices of 64), 2^20
   samples per point in rounds of 65536, R = 8, once per sampler: one
   launch per wave, no fallback, each launch held round by round against
   the plain version with the same rounds, window starts and sweep
   pairs, slice 0's 64 points sha256-equal to per-point families launched
   with the same fn ids and windows, one wave timed against its bound,
   the overlapping prefix sweep a[:16] x b served with 0 launches, and a
   traced run's split of the wall by pipeline stage;
16. service configuration 2 with ``sampler="sobol"`` held against
   ``evaluate(sampler="sobol", n_samples=2^20)``;
17. VEGAS importance grids at the paper's width: 1024 peaked integrands
   (Genz corner peaks 512 x 3-d and 384 x 4-d, 128 narrow Gaussians over
   R^2, compactified), each family's grid fitted on the card in three
   pilot-and-refine epochs; per sampler (MC and Sobol): kernel vs plain
   raw sums at N = 65536 (rtol=1e-4, atol=1e-2), repeat and R = 4 round
   digests, ``evaluate(num_trials=10)`` at N = 10^6 with 30 launches (all
   adapted), 2-sigma coverage >= 0.85 against the exact values, kernel vs
   plain at N = 10^6 within the tolerance of step 7, the kernel timed
   beside its bound and its pass-1 instantiation's registers, resident
   blocks per SM and SASS instructions per draw; then the median
   unadapted-to-adapted ratio of
   ``trial_std`` (MC), which must exceed 1;
18. adaptive requests through the service, the protocol of repro's
   BENCH_10 (``benchmarks/service_bench.py``): a Genz corner peak at
   stderr 5e-5 and narrow Gaussians over R^2 at 5e-4, fixed against
   ``adaptive=True``: >= 5x fewer samples with the pilots charged, >= 1
   refit, estimates within 6 sigma of the exact values and of the fixed
   path; an adapted run abandoned after 3 waves and resumed from its state
   dir sha256-equal to an uninterrupted one with the same stream ids; then
   step 17's 1024 integrands as three adaptive requests: 0 fallback
   rounds and at most 3 launches per wave;
19. stratified sampling: the stratum-moments kernel
   (``kernels/csrc/moments.cu``) on the value matrix of ZMCNormal's dim-8
   initial table (6561 strata x 2048 samples, 53.7 MB) and on a 512 MiB
   matrix, against its plain version and the two-pass formula (count
   exact, mean atol=1e-5, M2 rtol=1e-4) with repeat digests, timed beside
   its HBM bound and ``torch.var_mean``; ``eval_strata(use_kernel=True)``
   (one launch) against the plain path; ``ZMCNormal`` with its defaults
   on an 8-d Genz Gaussian peak, 5 trials, within 4 trial standard
   deviations of the exact value;
20. the multi-device path (``mesh=``): the Fig.-1 evaluate at N = 10^6 x
   10 trials, MC and Sobol, on a (1, 1) mesh of a world-size-1 NCCL group,
   sha256-equal to steps 6 and 14 with 30 launches each, timed beside one
   device in turns (the collectives' cost); then four gloo ranks spawned
   on this card (not scaling: they split it), each holding its launches
   to the CUDA kernel: the (1, 4) mesh's per-function sums sha256-equal to
   the single launch, (4, 1) and (2, 2) raw sums at N = 65538 within the
   ROADMAP's tolerances of one device with n exact and estimates at 10^6
   within 1e-2 of a standard error of steps 6 and 14, one digest over the
   ranks and repeats of (2, 2), an R = 4 sharded launch sha256-equal to 4
   single rounds, service configuration 2 on (2, 2) against step 12,
   ``ZMCNormal`` at dim 8 on (2, 2) (the moments kernel per rank) against
   step 19, ``compressed_psum`` within its int8 bound, and each rank's
   kernel ms for its shard of a Fig.-1 trial (against plain at 65536)
   beside the collectives' ms;
21. a state dir on a mesh and the invariant checker: four gloo ranks on
   this card serve service configuration 2 on the (2, 2) mesh with a state
   dir that rank 0 owns, abandoned after its first wave (no close()) and
   resumed by four new ranks: every launch the CUDA kernel, the resumed
   run only the remaining wave, its estimates sha256-equal to step 20's
   run on every rank, a warm replay with 0 launches, lease.json naming
   only rank 0's pid; each wave's wall beside step 20's, with the time
   in the store's operations, and warm ranks in turns without and with a
   state dir (the journal's cost per wave); then the port's auditor
   (``repro_torch.analysis.streams.audit_state_dir``) over the state dirs
   of steps 11, 18 and 21 (the abandoned journal included; 0 violations
   each, its ms), and
   ``python -m repro_torch.analysis``'s main (the lint and every form's
   contracts) exiting 0; then prints the ``{"kernels": [...]}`` line, one
   entry per kernel variant (the Sobol sweep's launches as
   ``fused_mc_sobol_swept``, the adapted Sobol ones as
   ``fused_mc_sobol_adapted``, a rank's shard on the (2, 2) mesh as
   ``fused_mc_sharded``) and the stratum-moments kernel.

Every path is driven with the kernel's launch counters set to 0 just
before it and read just after; a variant the path should run and did
not fails the script.  Any failed check exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script fails and prints no result.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_CHECK = 65536          # samples per function for the first kernel-vs-plain check
N_MAIN = 10**6           # the paper's protocol: 10^6 samples x 10 trials
TRIALS = 10
TIMING_REPS = 5
RTOL, ATOL = 1e-4, 1e-2  # kernel vs plain on raw sums (f32 order, FMA contraction)
# Kernel vs plain at N_MAIN, on the estimates: each mean and standard error
# within this fraction of the plain standard error.  One 16384-sample chunk
# drawn with other counters, lost, doubled or not cut at n_valid moves a
# mean by about sqrt(16384 / 10^6) = 0.13 standard errors, so the worst of a
# bucket's functions lands far past the limit; f32 rounding stays well under.
EST_TOL = 1e-2

# The least work of one draw (one Threefry-2x32 first word per function,
# sample and dim), with what is the same for every sample of a (function,
# dim) left out: x1 = c1 + k1 and round 1's rotate of it.  Rounds 1-20
# each add; the x0 key injections after rounds 4, 8, 12 and 16 fold into
# the next round's add (one three-input IADD3); the x1 injections after
# rounds 4-16 are 4 adds and the last x0 injection 1; round 20's rotate and
# xor feed only the unused second word.
TF_ADDS = 20 + 4 + 1          # the ALU pipe (IADD3) or the FMA pipe (IMAD) takes them
TF_ALU_ONLY = 18 + 19 + 1     # rotates (rounds 2-19), xors (rounds 1-19), >> 8
CONV_PER_DRAW = 1             # u32 -> f32
FP32_PER_DRAW = 3             # the 2^-24 scale, the affine map, the body's step
FP32_PER_VALUE = 30           # the body's finish (cos/sin/exp/log) and the sums
# Per clock per SM on Hopper (CUDA C++ Programming Guide, throughput of
# arithmetic instructions, compute capability 9.0): 32-bit integer add,
# logic and shift 64 (ALU pipe), 32-bit float add/mul/fma 128 (FMA pipes,
# which also take IMAD at 64), type conversions 16; 4 schedulers issue
# one warp instruction (32 lanes) each per clock.
ALU_PER_CLK, FMA_PER_CLK, IMAD_PER_CLK, CONV_PER_CLK, ISSUE_PER_CLK = 64, 128, 64, 16, 128
HBM_BYTES_PER_S = 3.35e12
# The compactification of one axis, at least: what an f32 tan map and
# half-line map must compute on the only path the clamp leaves them (|a| <
# pi/2), whatever a compiler emits for them; what is the same for every
# sample of a (function, dim), the kind and its tests, is left out.  Both
# maps: the clamp's min and max (ALU pipe) and the Jacobian's product (1).
# The tan map: u - 1/2 and the scale by pi (2); one range reduction shared
# by sin and cos (the quadrant rounded with a shifter constant and taken
# back, 2, its parity read from the sum's bits, 1 ALU; three Cody-Waite
# products, 3); r^2 (1); the sin polynomial to r^7 (2 Horner steps, r r^2
# and the last FMA, 4) and the cos polynomial to r^8 (4); the quadrant's
# swap of sin and cos and its sign (3 ALU); one reciprocal of the cosine
# (1 SFU) with its Newton step (2), shared by tan = sin / cos (the
# quotient, its residual and its correction, 3) and the Jacobian pi / cos^2
# (2): 24 FP32, 1 SFU, 6 ALU.  The half-line map: 1 - u (1); one reciprocal
# (1 SFU) with its Newton step (2), shared by u / (1 - u) (3) and the
# Jacobian 1 / (1 - u)^2 (1); the shift (1): 9 FP32, 1 SFU, 2 ALU.
# Reciprocals go to the special-function unit, 16 per clock per SM.
TAN_AXIS = dict(fp32=2 + 2 + 3 + 1 + 4 + 4 + 2 + 3 + 2 + 1, sfu=1, conv=0, alu=2 + 1 + 3)
HALF_AXIS = dict(fp32=1 + 2 + 3 + 1 + 1 + 1, sfu=1, conv=0, alu=2)
SFU_PER_CLK = 16

# The least a Sobol point costs per (sample index, dim), walked in Gray-code
# order: the index's trailing ones (a NOT, a bit reverse and a
# find-leading-one) pick one direction vector, and one XOR applies it.
SOBOL_ALU_PER_POINT = 4

# The importance map of one adapted axis, at least: the bin select (the
# scale by n_bins, a float -> int conversion, the min with n_bins - 1, the
# int -> float conversion and the fraction), the bin's width, the
# interpolation, the Jacobian factor and its product: 6 float operations,
# 2 conversions and 1 ALU operation (the two shared-memory loads of the
# bin's edges are not counted); one more multiply per value folds the
# grid's Jacobian product in.
FP32_PER_ADAPT_AXIS, CONV_PER_ADAPT_AXIS, ALU_PER_ADAPT_AXIS = 6, 2, 1

N_ROUND = 65536          # samples per round in the rounds check (step 9)
ROUNDS = 4
N_FULL = 1 << 20         # step 12: samples per integrand through the service
FULL_ROUND, FULL_R = 65536, 8
# step 15: the Fig.-1 4-d harmonic template swept over a 32 x 32 (a, b) grid
SWEEP_A = (0.5, 2.0, 32)
SWEEP_B = (-1.0, 1.0, 32)
SWEEP_SLICE = 64
SWEEP_PREFIX = 16        # the overlapping sweep's a axis: a[:16] x b, 8 aligned slices
# step 17: importance grids fitted in 3 pilot-and-refine epochs of 4096
# samples per function, 16 bins per axis (repro.core.adaptive.N_BINS)
ADAPT_EPOCHS, ADAPT_PILOT, ADAPT_BINS = 3, 4096, 16
# step 18: the engine knobs of repro's adaptive benchmark phase
# (benchmarks/service_bench.py, BENCH_10), and its resume check's target
# (tighter than the benchmark's 2e-4, so the run spans 4 waves and the
# abandoned engine stops mid-flight)
BENCH10_KW = dict(seed=0, round_samples=8192, pipeline_waves=False,
                  adapt_rounds_per_epoch=1, adapt_max_epochs=3,
                  adapt_pilot_samples=2048)
RESUME_TARGET = 5e-5
# step 19: ZMCNormal's defaults (repro/core/normal.py) at dim 8: 3^8 = 6561
# strata of 2048 samples, depth 8, k_split 32; and a matrix of 512 MiB to
# read the stratum-moments kernel's bandwidth
NORMAL_DIM, NORMAL_SPLITS, NORMAL_N_PER, NORMAL_TRIALS = 8, 3, 2048, 5
# step 20: four gloo ranks share the card; raw sums at an n not divisible by
# them, against one device within the ROADMAP's tolerances
MESH_RANKS = 4
N_ODD = N_CHECK + 2
MESH_TOL = {"mc": dict(rtol=5e-5, atol=5e-3), "sobol": dict(rtol=1e-4, atol=1e-2)}
BIG_MOMENTS = (32768, 4096)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def fig1_spec(device):
    import numpy as np
    from repro_torch.core import genz
    from repro_torch.core.integrand import (MultiFunctionSpec, abs_sum_family,
                                            gaussian_family, harmonic_family)
    osc, osc_exact = genz.oscillatory(100, 3)
    corner, corner_exact = genz.corner_peak(100, 4)
    fams = [
        harmonic_family(500, 4),                               # Eq. (1)
        harmonic_family(200, 2),
        abs_sum_family(49, 2, np.ones(49)),                    # Eq. (2), n < 50
        abs_sum_family(151, 3, np.ones(151), sign_last=-1.0),  # Eq. (2), n >= 50
        gaussian_family(100, 4),
        osc,
        corner,
    ]
    return (MultiFunctionSpec.from_families(fams).to(device),
            {5: osc_exact, 6: corner_exact})


def launch_bucket(fn, bucket, n_samples, key, **kw):
    import math
    from repro_torch.kernels import template
    return fn(template.pack_scalars(key, 0, n_samples), bucket.fn_ids,
              bucket.packed, bucket.lo, bucket.hi, bucket.block_forms,
              dim=bucket.dim,
              n_sample_blocks=max(1, math.ceil(n_samples / template.S_BLK)), **kw)


def real_rows(bucket, out):
    import torch
    return torch.cat([out[0, s.row_start:s.row_start + s.n_fn]
                      for s in bucket.slices])


def sum_ratio(diff, plain):
    """Worst |diff| / (atol + rtol |plain|): at most 1 where allclose holds."""
    return float((diff / (ATOL + RTOL * plain.abs())).max())


def compare_sums(bucket, k_out, p_out, n_samples) -> float:
    """Hold a kernel launch's raw sums against the plain version's on the
    bucket's real rows within rtol/atol; returns max |diff|."""
    import torch
    kr, pr = real_rows(bucket, k_out), real_rows(bucket, p_out)
    check(bool(torch.isfinite(kr).all()), f"d{bucket.dim}: non-finite sums")
    diff = (kr - pr).abs()
    ok = torch.allclose(kr, pr, rtol=RTOL, atol=ATOL)
    print(f"bucket d{bucket.dim} at N={n_samples}: kernel vs plain sums max|diff| "
          f"s1 {float(diff[:, 0].max()):.6g}, s2 {float(diff[:, 1].max()):.6g}; "
          f"worst |diff| / (atol + rtol |plain|) {sum_ratio(diff, pr):.4f} "
          f"(rtol={RTOL}, atol={ATOL}: {'ok' if ok else 'FAIL'})")
    check(ok, f"d{bucket.dim} at N={n_samples}: kernel disagrees with the plain version")
    return float(diff.max())


def compare_estimates(bucket, k_out, p_out, n_samples) -> float:
    """Hold the estimates a launch gives (mean and standard error per
    function, as ``direct_mc.finalize`` makes them; the box volume cancels)
    against the plain version's: both within EST_TOL of the plain standard
    error.  The raw-sum tolerance of ``compare_sums`` is printed beside it
    but not held: its atol is fixed while f32 rounding differences of a
    sum grow with its length.  Returns max |diff| of the raw sums."""
    import torch
    kr, pr = real_rows(bucket, k_out), real_rows(bucket, p_out)
    check(bool(torch.isfinite(kr).all()), f"d{bucket.dim}: non-finite sums")

    def estimates(rows):
        r = rows.double()
        mean = r[:, 0] / n_samples
        var = torch.clamp(r[:, 1] / n_samples - mean * mean, min=0.0)
        return mean, torch.sqrt(var / n_samples)

    (km, kse), (pm, pse) = estimates(kr), estimates(pr)
    check(bool((pse > 0).all()), f"d{bucket.dim}: a zero standard error")
    d_mean = float(((km - pm).abs() / pse).max())
    d_se = float(((kse - pse).abs() / pse).max())
    diff = (kr - pr).abs()
    ok = d_mean <= EST_TOL and d_se <= EST_TOL
    print(f"bucket d{bucket.dim} at N={n_samples}: kernel vs plain estimates: "
          f"max |d mean| {d_mean:.3g} and max |d stderr| {d_se:.3g} standard "
          f"errors (limit {EST_TOL}: {'ok' if ok else 'FAIL'}); sums max|diff| "
          f"s1 {float(diff[:, 0].max()):.6g}, s2 {float(diff[:, 1].max()):.6g}, "
          f"{sum_ratio(diff, pr):.4f} of the N={N_CHECK} sum tolerance")
    check(ok, f"d{bucket.dim} at N={n_samples}: kernel estimates disagree "
              f"with the plain version's")
    return float(diff.max())


def op_bound_ms(draws: float, values: float, n_sm: int, clock_hz: float,
                tan_axes: float = 0.0, half_axes: float = 0.0,
                adapt_axes: float = 0.0, adapt_values: float = 0.0) -> dict:
    """The least time the card needs for these operations, per resource
    (ms).  Integer adds go to whichever of the ALU and FMA pipes leaves
    the busier one least loaded.  ``tan_axes`` and ``half_axes`` count
    draws through the compactification's tan map and half-line map,
    ``adapt_axes`` draws through an importance grid and ``adapt_values``
    the values its Jacobian multiplies."""
    def axes(k):                        # the compactification's operations of kind k
        return tan_axes * TAN_AXIS[k] + half_axes * HALF_AXIS[k]

    alu_only = draws * TF_ALU_ONLY + adapt_axes * ALU_PER_ADAPT_AXIS + axes("alu")
    adds = draws * TF_ADDS
    fp = (draws * FP32_PER_DRAW + values * FP32_PER_VALUE + axes("fp32")
          + adapt_axes * FP32_PER_ADAPT_AXIS + adapt_values)
    conv = draws * CONV_PER_DRAW + adapt_axes * CONV_PER_ADAPT_AXIS + axes("conv")
    sfu = axes("sfu")

    def pipes(a):                       # a: adds issued on the ALU pipe
        return max((alu_only + a) / ALU_PER_CLK, (adds - a) / IMAD_PER_CLK,
                   (adds - a + fp) / FMA_PER_CLK)

    clocks = {
        "ALU and FMA pipes": min(pipes(adds * i / 100) for i in range(101)),
        "issue": (alu_only + adds + fp + conv + sfu) / ISSUE_PER_CLK,
        "conversion": conv / CONV_PER_CLK,
        "special functions": sfu / SFU_PER_CLK,
    }
    return {k: v / (n_sm * clock_hz) * 1e3 for k, v in clocks.items()}


def sobol_op_bound_ms(draws: float, values: float, point_dims: float, n_sm: int,
                      clock_hz: float, tan_axes: float = 0.0, half_axes: float = 0.0,
                      adapt_axes: float = 0.0, adapt_values: float = 0.0) -> dict:
    """The least time the card needs for a Sobol launch's operations, per
    resource (ms).  A draw is one XOR with its shift on the ALU pipe, one
    u32 -> f32 conversion and FP32_PER_DRAW float operations; a point
    costs SOBOL_ALU_PER_POINT ALU operations per distinct (sample index,
    dim) the launch draws (``point_dims``, from :func:`distinct_point_dims`),
    once however many functions and blocks share it; the values cost what
    they cost under MC, and the stages (``tan_axes``, ``half_axes``,
    ``adapt_axes``, ``adapt_values``) what they cost in :func:`op_bound_ms`."""
    def axes(k):                        # the compactification's operations of kind k
        return tan_axes * TAN_AXIS[k] + half_axes * HALF_AXIS[k]

    alu = (draws + point_dims * SOBOL_ALU_PER_POINT + adapt_axes * ALU_PER_ADAPT_AXIS
           + axes("alu"))
    conv = draws * CONV_PER_DRAW + adapt_axes * CONV_PER_ADAPT_AXIS + axes("conv")
    fp = (draws * FP32_PER_DRAW + values * FP32_PER_VALUE + axes("fp32")
          + adapt_axes * FP32_PER_ADAPT_AXIS + adapt_values)
    sfu = axes("sfu")
    clocks = {"ALU pipe": alu / ALU_PER_CLK, "FMA pipes": fp / FMA_PER_CLK,
              "issue": (alu + conv + fp + sfu) / ISSUE_PER_CLK,
              "conversion": conv / CONV_PER_CLK,
              "special functions": sfu / SFU_PER_CLK}
    return {k: v / (n_sm * clock_hz) * 1e3 for k, v in clocks.items()}


def distinct_point_dims(plan, n_samples: int, round_bases=None, n_rounds: int = 1,
                        round_stride: int = 0) -> float:
    """(sample index, dim) pairs whose Sobol points a launch of each of
    ``plan``'s buckets needs: the union of its blocks' windows (each
    ``n_samples`` long at ``round_base + r * round_stride``, u32 windows
    taken as integers) times its dim.  Every block of a bucket at the same
    window draws the same points (the functions differ only in their
    shifts), so a Fig.-1 bucket needs ``n_samples * dim`` and a sweep
    wave's slices share theirs.  ``round_bases``: one per-block window
    tensor per bucket, or None for all 0."""
    total = 0
    for i, b in enumerate(plan.buckets):
        bases = {0} if round_bases is None else set(round_bases[i].tolist())
        starts = sorted({x + r * round_stride for x in bases for r in range(n_rounds)})
        covered, end = 0, -1
        for x in starts:
            covered += max(0, x + n_samples - max(x, end))
            end = max(end, x + n_samples)
        total += covered * b.dim
    return float(total)


def built_point_dims(plan, n_samples: int) -> float:
    """(sample, function block, dim) triples the kernel computes points for:
    each CUDA block walks its own, so a point is stepped (or built, at a
    thread's first sample) once per 16-function block that draws it (the
    kernel's overhead over :func:`distinct_point_dims`)."""
    from repro_torch.kernels import template
    return float(n_samples) * sum(b.fn_ids.shape[0] // template.F_BLK * b.dim
                                  for b in plan.buckets)


ALU_OPS = ("IADD3", "LOP3", "SHF", "PRMT", "LEA", "ISETP", "FSETP", "SEL",
           "FSEL", "IMNMX", "FMNMX", "IABS", "MOV", "PLOP3")
FMA_OPS = ("IMAD", "FFMA", "FADD", "FMUL")


@functools.lru_cache(maxsize=2)
def _cuobjdump(lib_path) -> str | None:
    import shutil
    from repro_torch.kernels import build
    tool = (shutil.which("cuobjdump")
            or os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump"))
    try:
        out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                             text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout if out.returncode == 0 else None


def sass_listing(lib_path, function: str) -> list[tuple] | None:
    """(address, opcode, operands) of each instruction of
    the function whose mangled name contains ``function``, from
    ``cuobjdump -sass`` of the built library; None when the tool is missing
    or its listing cannot be read."""
    import re
    listing = _cuobjdump(str(lib_path))
    if listing is None:
        return None
    body, inside = [], False
    for line in listing.splitlines():
        if "Function :" in line:
            inside = function in line
        elif inside:
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);",
                          line)
            if m:
                body.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return body


def sass_loops(lib_path, function: str = "fused_mc_pass1ILi0ELb0ELb0EE") -> list[dict] | None:
    """Instruction mix of the innermost loops of one pass-1 instantiation
    (by default the main path's MC one without compactified or swept
    blocks, ``fused_mc_pass1<0, false, false>``; its mangled name is
    ``function``), read from ``cuobjdump -sass`` of the built library: per
    loop its instructions, draws (one u32 -> f32 conversion each),
    rotates, shared-memory loads and opcode counts.  None when the tool is
    missing or its listing cannot be read: this is a report of what nvcc
    emitted, not a check."""
    import collections
    import re
    body = sass_listing(lib_path, function)
    if body is None:
        return None
    loops = []
    for addr, op, args in body:
        t = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        if t and int(t.group(1), 16) <= addr:
            loops.append((int(t.group(1), 16), addr))
    inner = [(a, b) for a, b in loops
             if not any((c, d) != (a, b) and a <= c and d <= b for c, d in loops)]
    found = []
    for a, b in inner:
        ops = collections.Counter(op for addr, op, _ in body if a <= addr <= b)
        found.append({
            "range": f"0x{a:x}-0x{b:x}",
            "draws": sum(n for op, n in ops.items() if op.startswith("I2F")),
            "rotates": sum(n for op, n in ops.items()
                           if op.startswith("SHF") and ".W" in op),
            "lds": sum(n for op, n in ops.items() if op.startswith("LDS")),
            "instr": sum(ops.values()),
            "alu": sum(n for op, n in ops.items() if op.split(".")[0] in ALU_OPS),
            "fma": sum(n for op, n in ops.items() if op.split(".")[0] in FMA_OPS),
            "ops": ops})
    return found or None


def pass1_report(lib_path, res: dict, name: str) -> str:
    """One line for a pass-1 instantiation ``name`` (``<stages,sobol,swept>``,
    as ``build.pass1_resources`` names it; ``res`` its entry there): its
    registers, spill stores and resident blocks per SM, and the SASS
    instructions per draw of its innermost drawing loops (a draw is one
    unsigned u32 -> f32 conversion: the uniform's; an adapted axis' bin
    conversion is signed), split into the loops that draw 16 at a time (dim
    outer, the 16 functions inside) and the rest."""
    import re
    st, sob, sw = re.match(r"<(\d),(\w+),(\w+)>", name).groups()
    mangled = f"fused_mc_pass1ILi{st}ELb{int(sob == 'true')}ELb{int(sw == 'true')}EE"
    line = (f"fused_mc_pass1{name}: {res['registers']} registers, {res['spill_stores']} "
            f"bytes of spill stores, {res['blocks_per_sm']} resident blocks per SM")
    loops = sass_loops(lib_path, mangled)
    if not loops:
        return line + "; SASS not measured (no listing)"
    for lp in loops:
        lp["udraws"] = sum(n for op, n in lp["ops"].items()
                           if op.startswith("I2F") and "U32" in op)
    groups = {"16 draws an iteration": [lp for lp in loops if lp["udraws"] >= 16],
              "1-15 draws an iteration": [lp for lp in loops if 0 < lp["udraws"] < 16]}
    for label, ls in groups.items():
        if ls:
            n = sum(lp["udraws"] for lp in ls)
            line += (f"; {len(ls)} loops of {label}: "
                     f"{sum(lp['instr'] for lp in ls) / n:.2f} SASS instructions and "
                     f"{sum(lp['lds'] for lp in ls) / n:.2f} LDS per draw")
    return line


def compact_spec(device):
    """Step 10's spec: Gaussians over R^d and [0, inf)^d (sigma 0.5-2)
    mixed with finite harmonic and Genz families, at d = 2, 3, 4."""
    import numpy as np
    from repro_torch.core import genz
    from repro_torch.core.integrand import (MultiFunctionSpec, gaussian_family,
                                            harmonic_family)
    fams, exact = [], {}
    for d in (2, 3, 4):
        exact[len(fams)] = ("R^d", d)
        fams.append(gaussian_family(64, d, lo=-np.inf, hi=np.inf))
        exact[len(fams)] = ("[0,inf)^d", d)
        fams.append(gaussian_family(64, d, lo=0.0, hi=np.inf))
        fams.append(harmonic_family(48, d))
        fams.append(genz.oscillatory(32, d)[0])
    return MultiFunctionSpec.from_families(fams).to(device), exact


def adapted_spec(device):
    """Step 17's spec, 1024 peaked integrands: Genz corner peaks 512 x 3-d
    and 384 x 4-d (difficulty 4) and 128 narrow Gaussians over R^2 (sigma
    0.2-0.35, compactified), each family's importance grid fitted on the
    card in ADAPT_EPOCHS epochs of ``initial_edges`` -> ``pilot_weights``
    -> ``refine_edges``.  Returns the adapted spec, the same families
    without grids, and the exact values."""
    import numpy as np
    from repro_torch.core import adaptive, genz, rng
    from repro_torch.core.integrand import (MultiFunctionSpec, gaussian_analytic,
                                            gaussian_family)
    c3, e3 = genz.corner_peak(512, 3, difficulty=4.0)
    c4, e4 = genz.corner_peak(384, 4, difficulty=4.0)
    sigma = np.linspace(0.2, 0.35, 128).astype(np.float32)
    gauss = gaussian_family(128, 2, sigma=sigma, lo=-np.inf, hi=np.inf)
    base = [f.to(device) for f in (c3, c4, gauss.compactified())]
    adapted = []
    for i, fam in enumerate(base):
        edges = adaptive.initial_edges(fam.domains, ADAPT_BINS)
        for epoch in range(1, ADAPT_EPOCHS + 1):
            weights = adaptive.pilot_weights(fam, edges, rng.fold_key(14, 16 * i + epoch),
                                             ADAPT_PILOT)
            edges = adaptive.refine_edges(edges, weights)
        adapted.append(fam.adapted(edges, epoch=ADAPT_EPOCHS))
    exact = np.concatenate([e3, e4, gaussian_analytic(128, 2, sigma=sigma)])
    return (MultiFunctionSpec.from_families(adapted),
            MultiFunctionSpec.from_families(base), exact)


def sha256_of(t) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def variant_counts(expect: dict, what: str) -> dict:
    """Read the per-variant kernel launch counts after a path, print them,
    and fail if a variant the path runs was launched no time."""
    from repro_torch.kernels import template
    counts = template.kernel_launch_counts()
    print(f"{what}: kernel launches by variant {counts}")
    for name, must in expect.items():
        if must:
            check(counts[name] > 0, f"{what}: variant {name} never launched")
    return counts


def traced_split(reqs, **engine_kw) -> str:
    """Serve ``reqs`` synchronously on a fresh engine with tracing on and
    return the wall and the trace's time per pipeline stage (wal_commit
    runs inside deposit), as one printable line."""
    import torch
    from repro_torch.obs import Observability
    from repro_torch.obs.trace import STAGES, span_totals
    from repro_torch.service import IntegrationEngine
    events = []
    engine = IntegrationEngine(device="cuda", obs=Observability.enabled(
        sinks=[events.append]), **engine_kw)
    t0 = time.perf_counter()
    tickets = [engine.submit(r) for r in reqs]
    while engine.step():
        pass
    check(all(engine.poll(t) is not None for t in tickets), "traced run unfinished")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine.close()
    tot = span_totals(events)
    per_wave = {k: [round(ev["dur"] / 1e3, 3) for ev in events
                    if ev.get("ph") == "X" and ev["name"] == k]
                for k in ("launch", "device_execute", "deposit")}
    return (f"{1e3 * wall:.3f} ms wall over {engine.stats.waves} waves; "
            + ", ".join(f"{k} {1e3 * tot.get(k, 0.0):.3f} ms "
                        f"({100 * tot.get(k, 0.0) / wall:.1f}%)" for k in STAGES)
            + f"; submits and the rest {1e3 * (wall - sum(tot.get(k, 0.0) for k in STAGES if k != 'wal_commit')):.3f} ms"
            + "".join(f" (of which {k} {1e3 * v:.3f} ms)" for k, v in tot.items()
                      if k not in STAGES)
            + "; ms per wave: " + ", ".join(f"{k} {v}" for k, v in per_wave.items()))


def served_digest(results) -> str:
    import numpy as np
    h = hashlib.sha256()
    for r in results:
        h.update(np.ascontiguousarray(r.means, np.float32).tobytes())
        h.update(np.ascontiguousarray(r.stderrs, np.float32).tobytes())
    return h.hexdigest()


def mesh_rank() -> dict:
    """One of step 20's four gloo ranks, all on the card of the parent:
    every mesh check that needs the ranks, returned to the parent (which
    holds them against the single-device steps) as numpy and numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import genz, rng
    from repro_torch.core.multifunctions import ZMCMultiFunctions
    from repro_torch.core.normal import ZMCNormal
    from repro_torch.distributed import collectives, compression
    from repro_torch.kernels import template
    from repro_torch.kernels.mc_eval import multi
    from repro_torch.kernels.moments import ops as mops
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.service import IntegrationEngine, IntegrationRequest

    rank, world = dist.get_rank(), dist.get_world_size()
    device = torch.device("cuda", 0)
    spec, _ = fig1_spec(device)
    key = rng.fold_key(0, 0)
    plans = {s: multi.plan_spec(spec, sampler=s) for s in ("mc", "sobol")}
    meshes = {shape: make_mesh_for(model_parallel=shape[1], device="cuda")
              for shape in ((1, MESH_RANKS), (MESH_RANKS, 1), (2, 2))}
    out = {"rank": rank}

    def digest(states) -> str:
        h = hashlib.sha256()
        for i in sorted(states):
            h.update(states[i].s1.cpu().numpy().tobytes())
            h.update(states[i].s2.cpu().numpy().tobytes())
        return h.hexdigest()

    def sharded(plan, n, mesh):
        """sharded_eval_plan with the launches counted: every one through
        the CUDA kernel, on the card."""
        template.reset_kernel_launch_count()
        got = multi.sharded_eval_plan(plan, n, key, mesh)
        torch.cuda.synchronize()
        check(template.kernel_launch_count() == plan.n_launches,
              f"rank {rank}: {template.kernel_launch_count()} CUDA launches for "
              f"{plan.n_launches} buckets")
        check(all(st.s1.device.type == "cuda" for st in got.values()),
              f"rank {rank}: sums left the card")
        return got

    # (1, 4), functions only: each function's sums the single launch's bits
    out["fn_only_equal"] = {}
    for s, plan in plans.items():
        one = multi.eval_plan(plan, N_MAIN, key)
        got = sharded(plan, N_MAIN, meshes[(1, MESH_RANKS)])
        out["fn_only_equal"][s] = sum(digest({0: got[i]}) == digest({0: one[i]})
                                      for i in one)
    # (4, 1) and (2, 2): raw sums at N_ODD against one device, n exact, the
    # estimates at N_MAIN (held by the parent against steps 6 and 14)
    for shape in ((MESH_RANKS, 1), (2, 2)):
        mesh = meshes[shape]
        for s, plan in plans.items():
            one = multi.eval_plan(plan, N_ODD, key)
            got = sharded(plan, N_ODD, mesh)
            ok = all(torch.allclose(got[i].s1, one[i].s1, **MESH_TOL[s])
                     and torch.allclose(got[i].s2, one[i].s2, **MESH_TOL[s])
                     for i in one)
            worst = max(float((got[i].s1 - one[i].s1).abs().max()) for i in one)
            again = digest(sharded(plan, N_ODD, mesh))
            zmc = ZMCMultiFunctions(spec, n_samples=N_MAIN, seed=0, use_kernel=True,
                                    sampler=s, mesh=mesh)
            template.reset_kernel_launch_count()
            mops.reset_kernel_launch_count()
            est = zmc.evaluate(num_trials=1)
            torch.cuda.synchronize()
            out[(shape, s)] = dict(
                sums_ok=ok, max_abs=worst, digest=digest(got), repeat=again,
                n_exact=all(float(st.n) == N_ODD for st in got.values()),
                means=est.means[0], stderrs=est.stderrs[0],
                counts=template.kernel_launch_counts())
    mesh = meshes[(2, 2)]
    # R = 4 rounds in one sharded launch against 4 single-round ones
    start = {i: 3 * i for i in range(len(spec.families))}
    _, stack = multi.sharded_eval_plan_rounds(plans["mc"], N_ROUND, ROUNDS, key, mesh,
                                              start_rounds=start)
    same = 0
    for r in range(ROUNDS):
        _, one = multi.sharded_eval_plan_rounds(
            plans["mc"], N_ROUND, 1, key, mesh,
            start_rounds={i: v + r for i, v in start.items()})
        same += all(sha256_of(a[r]) == sha256_of(b[0]) for a, b in zip(stack, one))
    out["rounds_same"] = same
    # service configuration 2 on (2, 2), in memory (step 21 serves it again
    # with a state dir and holds it against this run)
    engine = IntegrationEngine(round_samples=FULL_ROUND, max_rounds_per_wave=FULL_R,
                               mesh=mesh)
    template.reset_kernel_launch_count()
    tickets = [engine.submit(IntegrationRequest.make([f], n_samples=N_FULL))
               for f in spec.families]
    wave_s = []
    while True:
        t0 = time.perf_counter()
        if not engine.step():
            break
        torch.cuda.synchronize()
        wave_s.append(time.perf_counter() - t0)
    served = [engine.poll(t) for t in tickets]
    torch.cuda.synchronize()
    out["service"] = dict(means=np.concatenate([r.means for r in served]),
                          stderrs=np.concatenate([r.stderrs for r in served]),
                          launches=template.kernel_launch_count(),
                          waves=engine.stats.waves, wave_s=wave_s,
                          fallback=engine.batcher.fallback_rounds)
    engine.close()
    # ZMCNormal at dim 8, samples over all four ranks, moments on the card
    gpeak = genz.gaussian_peak(1, NORMAL_DIM)[0].to(device)

    def normal_fn(x):
        return gpeak.fn(x.reshape(1, -1, NORMAL_DIM), gpeak.params).reshape(x.shape[:-1])

    mops.reset_kernel_launch_count()
    t0 = time.perf_counter()
    nres = ZMCNormal(normal_fn, np.tile([[0.0, 1.0]], (NORMAL_DIM, 1)), seed=0,
                     mesh=mesh, use_kernel=True).evaluate(num_trials=NORMAL_TRIALS)
    torch.cuda.synchronize()
    out["normal"] = dict(integral=nres.integral, trial_std=nres.trial_std,
                         s_per_trial=(time.perf_counter() - t0) / NORMAL_TRIALS,
                         moments_launches=mops.kernel_launch_count())
    # compressed_psum over "data" against the exact sum and its int8 bound
    x = torch.randn(4096, device=device, generator=torch.Generator(
        device=device).manual_seed(20 + collectives.axis_index(mesh, ("data",))))
    exact = collectives.psum_fixed(x, mesh, ("data",))
    comp = compression.compressed_psum(x, mesh, "data")
    amax = float(collectives.pmax(x.abs().max(), mesh, ("data",)))
    out["compressed"] = dict(err=float((comp - exact).abs().max()),
                             bound=2 * amax / 127 + 1e-5,
                             on_card=comp.device.type == "cuda")
    # the kernel on this rank's shard of one Fig.-1 trial: against its plain
    # version at N_CHECK, then timed at N_MAIN with the ranks taking turns
    per_shard, first, n_local = multi._sample_window(mesh, ("data",), N_MAIN)
    rbs = multi._rank_buckets(plans["mc"], mesh, "model")
    err = 0.0
    for rb in rbs:
        scal = template.pack_scalars(key, first, N_CHECK)
        k = multi._launch_local(rb, scal, N_CHECK // template.S_BLK, "mc")[0]
        b = rb.local
        p = template.fused_mc_plain(scal, b.fn_ids, b.packed, b.lo, b.hi, b.block_forms,
                                    dim=b.dim, n_sample_blocks=N_CHECK // template.S_BLK,
                                    block_tcols=b.block_tcols)[0]
        real = torch.zeros(b.fn_ids.shape[0], dtype=torch.bool, device=device)
        r0 = rb.b0 * template.F_BLK
        for sl in rb.padded.slices:
            lo_r, hi_r = max(sl.row_start, r0), min(sl.row_start + sl.n_fn, r0 + real.numel())
            if lo_r < hi_r:
                real[lo_r - r0:hi_r - r0] = True
        check(torch.allclose(k[real], p[real], rtol=RTOL, atol=ATOL),
              f"rank {rank}: the kernel disagrees with plain on its shard")
        err = max(err, float((k[real] - p[real]).abs().max()))
    rows = [int(sum(max(0, min(sl.row_start + sl.n_fn, (rb.b1) * template.F_BLK)
                        - max(sl.row_start, rb.b0 * template.F_BLK))
                    for sl in rb.padded.slices)) for rb in rbs]
    out["shard"] = dict(max_abs_err=err, n_local=n_local,
                        draws=sum(n * rb.local.dim for n, rb in zip(rows, rbs)) * n_local,
                        values=sum(rows) * n_local)
    scal = template.pack_scalars(key, first, n_local)
    blocks = -(-per_shard // template.S_BLK)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for turn in range(world):
        dist.barrier()
        if turn != rank:
            continue
        parts = [multi._launch_local(rb, scal, blocks, "mc")[0] for rb in rbs]
        torch.cuda.synchronize()
        ev0.record()
        for _ in range(TIMING_REPS):
            parts = [multi._launch_local(rb, scal, blocks, "mc")[0] for rb in rbs]
        ev1.record()
        torch.cuda.synchronize()
        out["shard"]["ms"] = ev0.elapsed_time(ev1) / TIMING_REPS
        if rank == 0:
            ev0.record()
            for rb in rbs:
                b = rb.local
                template.fused_mc_plain(scal, b.fn_ids, b.packed, b.lo, b.hi,
                                        b.block_forms, dim=b.dim, n_sample_blocks=blocks,
                                        block_tcols=b.block_tcols)
            ev1.record()
            torch.cuda.synchronize()
            out["shard"]["plain_ms"] = ev0.elapsed_time(ev1)
    dist.barrier()
    parts = [multi._launch_local(rb, scal, blocks, "mc")[0] for rb in rbs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMING_REPS):
        for part in parts:
            collectives.psum_gather_rows(part, mesh, ("data",), "model")
    torch.cuda.synchronize()
    out["shard"]["collectives_ms"] = (time.perf_counter() - t0) * 1e3 / TIMING_REPS
    return out


def state_rank(state_dir: str, waves) -> dict:
    """One of step 21's four gloo ranks: service configuration 2 on the
    (2, 2) mesh with a state dir that rank 0 owns.  With ``waves`` the run
    stops after that many waves and is abandoned (no close(): no
    snapshot, the lease left behind); without, it runs to the end, closes,
    and a fresh engine replays it warm.  Every wave is timed, with its
    ``deposit`` and ``wal_commit`` spans and the time the rank spent in
    the store's operations (each ends in a broadcast from rank 0), its
    kernel launches counted, and the pid in lease.json read after it."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import template
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.obs import Observability
    from repro_torch.obs.trace import span_totals
    from repro_torch.service import IntegrationEngine, IntegrationRequest

    device = torch.device("cuda", 0)
    spec, _ = fig1_spec(device)
    mesh = make_mesh_for(model_parallel=2, device="cuda")
    lease = os.path.join(state_dir, "lease.json")
    out = {"rank": dist.get_rank(), "pid": os.getpid(), "lease_pids": set()}

    def lease_pid():
        if os.path.exists(lease):
            with open(lease, encoding="utf-8") as f:
                out["lease_pids"].add(json.load(f)["pid"])

    def serve(stop=None, path=state_dir):
        events, store_s = [], [0.0]
        t0 = time.perf_counter()
        engine = IntegrationEngine(round_samples=FULL_ROUND, max_rounds_per_wave=FULL_R,
                                   mesh=mesh, state_dir=path,
                                   obs=Observability.enabled(sinks=[events.append]))
        run = dict(open_s=time.perf_counter() - t0)
        if path is not None:
            on_rank0 = engine.store._on_rank0

            def timed(fn, **kw):
                t = time.perf_counter()
                try:
                    return on_rank0(fn, **kw)
                finally:
                    store_s[0] += time.perf_counter() - t

            engine.store._on_rank0 = timed
        lease_pid()
        template.reset_launch_count()
        template.reset_kernel_launch_count()
        t0 = time.perf_counter()
        tickets = [engine.submit(IntegrationRequest.make([f], n_samples=N_FULL))
                   for f in spec.families]
        run["submit_s"] = time.perf_counter() - t0
        run.update(wave_s=[], store_s=[], deposit_s=[], wal_s=[])
        while stop is None or len(run["wave_s"]) < stop:
            del events[:]
            store_s[0] = 0.0
            t0 = time.perf_counter()
            if not engine.step():
                break
            torch.cuda.synchronize()
            run["wave_s"].append(time.perf_counter() - t0)
            tot = span_totals(events)
            run["store_s"].append(store_s[0])
            run["deposit_s"].append(tot.get("deposit", 0.0))
            run["wal_s"].append(tot.get("wal_commit", 0.0))
            lease_pid()
        served = [engine.poll(t) for t in tickets]
        run.update(dispatches=template.launch_count(),
                   kernel_launches=template.kernel_launch_count(),
                   counts=template.kernel_launch_counts(),
                   hits=sum(r is not None and r.served_from_cache for r in served),
                   fallback=engine.batcher.fallback_rounds)
        if all(r is not None for r in served):
            run["means"] = np.concatenate([r.means for r in served])
            run["stderrs"] = np.concatenate([r.stderrs for r in served])
        return engine, run

    if waves is not None:
        _, out["abandoned"] = serve(stop=waves)
        return out              # the engine is dropped unclosed
    engine, out["resumed"] = serve()
    t0 = time.perf_counter()
    engine.close()
    out["resumed"]["close_s"] = time.perf_counter() - t0
    engine, out["replay"] = serve()
    engine.close()
    # in these processes, now warm, turns without a state dir and with a
    # fresh one (none, dir, dir, none): the journal's cost per wave apart
    # from a fresh process's first wave
    out["turns"] = []
    for k, disk in enumerate((False, True, True, False)):
        engine, run = serve(path=f"{state_dir}_warm{k}" if disk else None)
        engine.close()
        out["turns"].append((disk, run["wave_s"], run["store_s"], run["submit_s"]))
    # one outcome broadcast alone (what every store operation adds)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(20):
        dist.broadcast_object_list([None, None], src=0)
    out["broadcast_s"] = (time.perf_counter() - t0) / 20
    # the state dir's file system: one journal-sized append and its fsync
    if out["rank"] == 0:
        path = os.path.join(state_dir, "fsync_probe")
        fsync_s = []
        with open(path, "ab") as f:
            for _ in range(5):
                f.write(os.urandom(100_000))
                f.flush()
                t0 = time.perf_counter()
                os.fsync(f.fileno())
                fsync_s.append(time.perf_counter() - t0)
        os.unlink(path)
        out["fsync_s"] = fsync_s
    return out


def main() -> None:
    sys.stdout.reconfigure(line_buffering=True)
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    import numpy as np

    from repro_torch.core import rng
    from repro_torch.core.integrand import harmonic_analytic
    from repro_torch.core.multifunctions import ZMCMultiFunctions
    from repro_torch.kernels import build, template
    from repro_torch.kernels.mc_eval import multi

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = nvidia_smi("name,power.limit")
    print(f"card: {card}", flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build(verbose=True)
    print(f"build: {len(built)} libraries in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    pass1 = {r["name"]: r for r in build.pass1_resources(built["zmc_fused_mc"]["log"])}
    for r in pass1.values():
        print(f"  fused_mc_pass1{r['name']}: {r['registers']} registers, "
              f"{r['spill_stores']} bytes of spill stores, {r['blocks_per_sm']} resident "
              f"blocks per SM")

    # -- 3. device Threefry, bit for bit ------------------------------------
    n = 1 << 20
    i = torch.arange(n, dtype=torch.int64, device=device)
    c0 = (2**32 - n // 2 + i) & rng.MASK32                  # wraps halfway
    fn_ids = (i * 2654435761) % (1 << 24)
    fn_ids[:1024] = (1 << 24) - 1                           # largest fn id
    c1 = (fn_ids * rng.DIM_STRIDE + i % rng.DIM_STRIDE) & rng.MASK32
    k0, k1 = rng.fold_key(2024, 7)
    got = template.random_bits_cuda(k0, k1, c0, c1)
    want = rng.random_bits(k0, k1, c0, c1)
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    print(f"zmc_random_bits vs rng.random_bits: {n - bad}/{n} equal "
          f"(c0 from {2**32 - n // 2} with wrap, fn ids up to 2^24-1)")
    check(bad == 0, f"device Threefry differs on {bad} counters")

    # -- 4. the Fig.-1 spec and its plan ------------------------------------
    spec, genz_exact = fig1_spec(device)
    plan = multi.plan_spec(spec)
    print(f"spec: {spec.n_fn_total} integrands in {len(spec.families)} families; "
          f"plan: {plan.n_launches} buckets "
          + ", ".join(f"d{b.dim}:{b.fn_ids.shape[0]} rows/"
                      f"{len(set(b.block_forms.tolist()))} forms"
                      for b in plan.buckets))
    check(plan.unfused == (), f"families left unfused: {plan.unfused}")
    check(plan.n_launches == 3, f"expected 3 buckets, got {plan.n_launches}")

    # -- 5. kernel vs plain at N_CHECK, and repeat digests -----------------
    key = rng.fold_key(0, 0)
    max_err = 0.0
    for b in plan.buckets:
        k_out = launch_bucket(template.fused_mc_cuda, b, N_CHECK, key)
        k_again = launch_bucket(template.fused_mc_cuda, b, N_CHECK, key)
        p_out = launch_bucket(template.fused_mc_plain, b, N_CHECK, key)
        torch.cuda.synchronize()
        max_err = max(max_err, compare_sums(b, k_out, p_out, N_CHECK))
        d1 = hashlib.sha256(k_out.cpu().numpy().tobytes()).hexdigest()
        d2 = hashlib.sha256(k_again.cpu().numpy().tobytes()).hexdigest()
        print(f"bucket d{b.dim} at N={N_CHECK}: repeat sha256 {d1[:16]} {d2[:16]} "
              f"{'equal' if d1 == d2 else 'DIFFER'}")
        check(d1 == d2, f"d{b.dim}: repeated launches differ")

    # -- 6. the main path ---------------------------------------------------
    zmc = ZMCMultiFunctions(spec, n_samples=N_MAIN, seed=0, use_kernel=True,
                            device="cuda")
    template.reset_launch_count()
    template.reset_kernel_launch_count()
    t0 = time.perf_counter()
    res = zmc.evaluate(num_trials=TRIALS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = template.kernel_launch_count()
    dispatches = template.launch_count()
    print(f"evaluate(num_trials={TRIALS}) at N={N_MAIN}: {wall / TRIALS:.4f} s "
          f"per trial (wall); kernel_launch_count() = {launches}, "
          f"launch_count() = {dispatches}")
    check(launches == plan.n_launches * TRIALS,
          f"expected {plan.n_launches * TRIALS} kernel launches, got {launches}")
    main_counts = variant_counts({"fused_mc": True}, "evaluate path")
    main_est = (res.means.copy(), res.stderrs.copy())    # held again in step 20
    check(res.means.shape == (TRIALS, spec.n_fn_total), "bad result shape")
    check(bool(np.isfinite(res.means).all() and np.isfinite(res.stderrs).all()),
          "non-finite estimates")

    fbar, dfn = res.trial_mean, res.trial_std
    exact_h = np.concatenate([harmonic_analytic(500, 4), harmonic_analytic(200, 2)])
    cover_h = float(np.mean(np.abs(fbar[:700] - exact_h) <= 2 * dfn[:700]))
    offs = spec.offsets()
    cover_g = {}
    for idx, exact in genz_exact.items():
        sl = slice(offs[idx], offs[idx] + spec.families[idx].n_fn)
        cover_g[spec.families[idx].name] = float(
            np.mean(np.abs(fbar[sl] - exact) <= 2 * dfn[sl]))
    print(f"harmonic 2-sigma coverage vs harmonic_analytic: {cover_h:.4f} "
          f"(700 integrands); Genz coverage vs exact: "
          + ", ".join(f"{k} {v:.4f}" for k, v in cover_g.items()))
    check(cover_h >= 0.85, f"harmonic coverage {cover_h} < 0.85")

    # -- 7. kernel vs plain at the main path's shapes, timing and bound -----
    # One trial's launches as evaluate makes them: N_MAIN samples, so 62
    # chunks per function, a cut last chunk and a 62-partial fold in pass 2.
    key = rng.fold_key(0, 0)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(TIMING_REPS):
        k_outs = [launch_bucket(template.fused_mc_cuda, b, N_MAIN, key)
                  for b in plan.buckets]
    ev1.record()
    torch.cuda.synchronize()
    kernel_ms = ev0.elapsed_time(ev1) / TIMING_REPS
    ev0.record()
    p_outs = [launch_bucket(template.fused_mc_plain, b, N_MAIN, key)
              for b in plan.buckets]
    ev1.record()
    torch.cuda.synchronize()
    plain_ms = ev0.elapsed_time(ev1)
    for b, k_out, p_out in zip(plan.buckets, k_outs, p_outs):
        max_err = max(max_err, compare_estimates(b, k_out, p_out, N_MAIN))

    props = torch.cuda.get_device_properties(device)
    try:
        clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    except ValueError:
        clock_hz = 1.98e9                    # H100 SXM boost clock, data sheet
    n_sm = props.multi_processor_count
    draws = sum(f.n_fn * f.dim for f in spec.families) * N_MAIN
    values = spec.n_fn_total * N_MAIN
    op_ms = op_bound_ms(draws, values, n_sm, clock_hz)
    n_bytes = sum(4 * (b.packed.numel() + b.lo.numel() + b.hi.numel()
                       + b.fn_ids.numel() + 2 * b.fn_ids.numel())
                  for b in plan.buckets)
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(*op_ms.values(), byte_ms)
    print(f"one trial (3 launches, {draws:.4g} draws, {values:.4g} values): kernel "
          f"{kernel_ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.3f} ms "
          f"(kernel at {100 * bound_ms / kernel_ms:.1f}% of it) at {n_sm} SMs x "
          f"{clock_hz / 1e9:.3f} GHz: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in op_ms.items())
          + f", bytes {byte_ms:.6f} ms; on {card}")

    loops = sass_loops(built["zmc_fused_mc"]["path"])
    loops = loops and [lp for lp in loops if lp["rotates"] >= 10 and lp["draws"]]
    if not loops:
        print("pass-1 SASS: not measured (cuobjdump missing or unreadable)")
    else:
        n_draws = sum(lp["draws"] for lp in loops)
        per_draw = {k: sum(lp[k] for lp in loops) / n_draws
                    for k in ("instr", "alu", "fma")}
        spread = [lp["instr"] / lp["draws"] for lp in loops]
        print(f"pass-1 SASS: {len(loops)} inner Threefry loops, "
              f"{sorted({lp['draws'] for lp in loops})} draws per iteration; per "
              f"draw {per_draw['instr']:.2f} instructions ({min(spread):.2f} to "
              f"{max(spread):.2f}): ALU {per_draw['alu']:.2f}, FMA pipes "
              f"{per_draw['fma']:.2f}, other "
              f"{per_draw['instr'] - per_draw['alu'] - per_draw['fma']:.2f}")
        top = max(loops, key=lambda lp: lp["instr"] / lp["draws"])
        print(f"  opcodes per draw in loop {top['range']}: " + ", ".join(
            f"{op} {n / top['draws']:g}" for op, n in top["ops"].most_common()))
        sass_clk = max(per_draw["alu"] / ALU_PER_CLK, per_draw["instr"] / ISSUE_PER_CLK)
        print(f"compiled-code bound (these loops' mix, every draw): "
              f"{draws * sass_clk / (n_sm * clock_hz) * 1e3:.3f} ms per trial "
              f"(ALU {per_draw['alu']:.2f} / {ALU_PER_CLK}, all "
              f"{per_draw['instr']:.2f} / {ISSUE_PER_CLK} per draw per clock per SM)")
    print(f"main path fused_mc_pass1<0,false,false>: "
          f"{pass1['<0,false,false>']['registers']} registers (its reference allocation: 96), "
          + (f"{per_draw['instr']:.2f}" if loops else "not measured")
          + " SASS instructions per draw (reference: 72.01)")

    # -- 8. where a steady-state trial's time goes ---------------------------
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    zmc.evaluate(num_trials=3)
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t0) / 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        zmc.evaluate(num_trials=1)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0))
                  for e in events) / 1e3
    print(f"steady state: {steady:.4f} s per trial (evaluate(3), wall); one "
          f"profiled trial {prof_ms:.1f} ms wall, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / prof_ms:.1f}%, idle {100 - 100 * busy_ms / prof_ms:.1f}%)")
    print(events.table(sort_by="self_cpu_time_total", row_limit=10))

    # -- 9. rounds: R-round launches against single rounds and plain ------
    key = rng.fold_key(4, 9)
    rounds_err = 0.0
    for b in plan.buckets:
        n_blocks = b.fn_ids.shape[0] // template.F_BLK
        base = torch.tensor([(i * 37 * N_ROUND) & rng.MASK32
                             for i in range(n_blocks)], dtype=torch.int64)
        base[n_blocks // 2] = 2**32 - 3 * N_ROUND // 2   # crosses the wrap
        kw = dict(dim=b.dim, n_sample_blocks=N_ROUND // template.S_BLK,
                  block_tcols=b.block_tcols, round_base=base)
        ops = (b.fn_ids, b.packed, b.lo, b.hi, b.block_forms)
        scal = template.pack_scalars(key, 0, N_ROUND, round_stride=N_ROUND)
        k_out = template.fused_mc_cuda(scal, *ops, n_rounds=ROUNDS, **kw)
        p_out = template.fused_mc_plain(scal, *ops, n_rounds=ROUNDS, **kw)
        torch.cuda.synchronize()
        same = 0
        for r in range(ROUNDS):
            one = template.fused_mc_cuda(
                template.pack_scalars(key, r * N_ROUND, N_ROUND), *ops, **kw)
            d_r = hashlib.sha256(k_out[r].cpu().numpy().tobytes()).hexdigest()
            d_1 = hashlib.sha256(one[0].cpu().numpy().tobytes()).hexdigest()
            same += d_r == d_1
        print(f"bucket d{b.dim}: R={ROUNDS} launch at N={N_ROUND} per round: "
              f"{same}/{ROUNDS} rounds sha256-equal to single-round launches "
              f"(window starts up to {int(base.max())}, one crossing 2^32)")
        check(same == ROUNDS, f"d{b.dim}: a round differs from its single-round launch")
        for r in range(ROUNDS):
            rounds_err = max(rounds_err, compare_sums(
                b, k_out[r:r + 1], p_out[r:r + 1], N_ROUND))

    # -- 10. compactified families -------------------------------------------
    cspec, c_exact = compact_spec(device)
    czmc = ZMCMultiFunctions(cspec, n_samples=N_MAIN, seed=3, use_kernel=True,
                             device="cuda")
    cplan = czmc._get_fusion_plan()
    check(cplan.unfused == () and cplan.n_launches == 3,
          f"compactified spec: {cplan.n_launches} buckets, unfused {cplan.unfused}")
    key = rng.fold_key(3, 0)

    def compact_launches():
        return [template.fused_mc_cuda(
            template.pack_scalars(key, 0, N_MAIN), b.fn_ids, b.packed, b.lo,
            b.hi, b.block_forms, dim=b.dim,
            n_sample_blocks=-(-N_MAIN // template.S_BLK),
            block_tcols=b.block_tcols) for b in cplan.buckets]

    compact_launches()                      # warm: first compactified launches
    torch.cuda.synchronize()
    ev0.record()
    for _ in range(TIMING_REPS):
        ck_outs = compact_launches()
    ev1.record()
    torch.cuda.synchronize()
    compact_ms = ev0.elapsed_time(ev1) / TIMING_REPS
    ev0.record()
    cp_outs = [template.fused_mc_plain(
        template.pack_scalars(key, 0, N_MAIN), b.fn_ids, b.packed, b.lo, b.hi,
        b.block_forms, dim=b.dim, n_sample_blocks=-(-N_MAIN // template.S_BLK),
        block_tcols=b.block_tcols) for b in cplan.buckets]
    ev1.record()
    torch.cuda.synchronize()
    compact_plain_ms = ev0.elapsed_time(ev1)
    compact_err = 0.0
    for b, k_out, p_out in zip(cplan.buckets, ck_outs, cp_outs):
        compact_err = max(compact_err, compare_estimates(b, k_out, p_out, N_MAIN))
    template.reset_kernel_launch_count()
    cres = czmc.evaluate(num_trials=1)
    variant_counts({"fused_mc": True, "fused_mc_compactified": True},
                   "compactified evaluate")
    from repro_torch.core.integrand import gaussian_analytic
    offs = cspec.offsets()
    covered, total = 0, 0
    for idx, (region, d) in c_exact.items():
        sl = slice(offs[idx], offs[idx] + cspec.families[idx].n_fn)
        want = gaussian_analytic(64, d, half=region != "R^d")
        pull = np.abs(cres.means[0][sl] - want) / cres.stderrs[0][sl]
        covered += int((pull <= 2).sum())
        total += len(want)
        print(f"gaussian over {region}, d={d}: 2-sigma coverage "
              f"{float(np.mean(pull <= 2)):.4f}, worst pull {float(pull.max()):.2f}, "
              f"mean/exact {float(np.mean(cres.means[0][sl] / want)):.5f}")
    cover_c = covered / total
    print(f"compactified Gaussians: 2-sigma coverage {cover_c:.4f} over {total} "
          f"integrals at N={N_MAIN}")
    check(cover_c >= 0.85, f"compactified coverage {cover_c} < 0.85")
    c_draws = sum(f.n_fn * f.dim for f in czmc.spec.families) * N_MAIN
    c_values = czmc.spec.n_fn_total * N_MAIN
    tan_axes = sum(f.n_fn * f.dim for f, (r, _) in
                   ((czmc.spec.families[i], v) for i, v in c_exact.items())
                   if r == "R^d") * N_MAIN
    half_axes = sum(f.n_fn * f.dim for f, (r, _) in
                    ((czmc.spec.families[i], v) for i, v in c_exact.items())
                    if r != "R^d") * N_MAIN
    c_op = op_bound_ms(c_draws, c_values, n_sm, clock_hz, tan_axes, half_axes)
    compact_bound = max(c_op.values())
    print(f"compactified buckets (3 launches, {c_draws:.4g} draws, "
          f"{tan_axes:.4g} tan-map and {half_axes:.4g} half-line axes): kernel "
          f"{compact_ms:.3f} ms, plain {compact_plain_ms:.1f} ms, bound "
          f"{compact_bound:.3f} ms (kernel at {100 * compact_bound / compact_ms:.1f}%): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in c_op.items()) + f"; on {card}")
    print("compactified pass 1: " + pass1_report(
        built["zmc_fused_mc"]["path"], pass1["<1,false,true>"], "<1,false,true>"))
    print(f"compactification per axis in the bounds: tan map {TAN_AXIS}, half-line "
          f"{HALF_AXIS}")

    # compactified Sobol: the same spec through fused_mc_pass1<1, true, true>
    cszmc = ZMCMultiFunctions(cspec, n_samples=N_MAIN, seed=3, use_kernel=True,
                              sampler="sobol", device="cuda")
    csplan = cszmc._get_fusion_plan()
    check(csplan.unfused == () and csplan.n_launches == 3 and csplan.sampler == "sobol",
          f"compactified Sobol spec: {csplan.n_launches} buckets, unfused {csplan.unfused}")
    cs_kw = [dict(sampler="sobol", dirvecs=b.dirvecs, block_tcols=b.block_tcols)
             for b in csplan.buckets]
    cs_err = 0.0
    for b, kw in zip(csplan.buckets, cs_kw):
        k_out = launch_bucket(template.fused_mc_cuda, b, N_CHECK, key, **kw)
        p_out = launch_bucket(template.fused_mc_plain, b, N_CHECK, key, sampler="sobol",
                              block_tcols=b.block_tcols)
        torch.cuda.synchronize()
        cs_err = max(cs_err, compare_sums(b, k_out, p_out, N_CHECK))
    template.reset_kernel_launch_count()
    csres = cszmc.evaluate(num_trials=1)
    cs_counts = variant_counts({"fused_mc": True, "fused_mc_sobol": True,
                                "fused_mc_compactified": True},
                               "compactified Sobol evaluate")
    check(cs_counts["fused_mc_sobol"] == cs_counts["fused_mc_compactified"]
          == csplan.n_launches, "a compactified Sobol launch ran as MC or unstaged")
    covered, total = 0, 0
    for idx, (region, d) in c_exact.items():
        sl = slice(offs[idx], offs[idx] + cspec.families[idx].n_fn)
        want = gaussian_analytic(64, d, half=region != "R^d")
        covered += int((np.abs(csres.means[0][sl] - want) <= 2 * csres.stderrs[0][sl]).sum())
        total += len(want)
    cover_cs = covered / total
    print(f"compactified Gaussians, Sobol: 2-sigma coverage {cover_cs:.4f} over "
          f"{total} integrals at N={N_MAIN}")
    check(cover_cs >= 0.85, f"compactified Sobol coverage {cover_cs} < 0.85")

    def compact_sobol_launches():
        return [launch_bucket(template.fused_mc_cuda, b, N_MAIN, key, **kw)
                for b, kw in zip(csplan.buckets, cs_kw)]

    compact_sobol_launches()
    torch.cuda.synchronize()
    ev0.record()
    for _ in range(TIMING_REPS):
        csk_outs = compact_sobol_launches()
    ev1.record()
    torch.cuda.synchronize()
    cs_ms = ev0.elapsed_time(ev1) / TIMING_REPS
    ev0.record()
    csp_outs = [launch_bucket(template.fused_mc_plain, b, N_MAIN, key, sampler="sobol",
                              block_tcols=b.block_tcols) for b in csplan.buckets]
    ev1.record()
    torch.cuda.synchronize()
    cs_plain_ms = ev0.elapsed_time(ev1)
    for b, k_out, p_out in zip(csplan.buckets, csk_outs, csp_outs):
        cs_err = max(cs_err, compare_estimates(b, k_out, p_out, N_MAIN))
    cs_pts = distinct_point_dims(csplan, N_MAIN)
    cs_op = sobol_op_bound_ms(c_draws, c_values, cs_pts, n_sm, clock_hz, tan_axes,
                              half_axes)
    cs_bound = max(cs_op.values())
    compact_sobol = dict(launches=cs_counts["fused_mc_compactified"], max_abs_err=cs_err,
                         ms=cs_ms, plain_ms=cs_plain_ms, bound_ms=cs_bound)
    print(f"compactified Sobol buckets (3 launches, {c_draws:.4g} draws, {cs_pts:.4g} "
          f"distinct point dims): kernel {cs_ms:.3f} ms, plain {cs_plain_ms:.1f} ms, "
          f"bound {cs_bound:.3f} ms (kernel at {100 * cs_bound / cs_ms:.1f}%): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in cs_op.items()) + f"; on {card}")
    print("compactified Sobol pass 1: " + pass1_report(
        built["zmc_fused_mc"]["path"], pass1["<1,true,true>"], "<1,true,true>"))

    # -- 11. the service on the launcher's defaults --------------------------
    import tempfile
    from repro_torch.launch import serve_integrals
    state = tempfile.mkdtemp(prefix="zmc_state_")
    base_args = ["--device", "cuda", "--requests", "64", "--n-fn", "8",
                 "--samples", "16384", "--round-samples", "8192",
                 "--max-rounds-per-wave", "8"]
    n_dims = 3                         # the workload's families span dims 2-4
    runs = {}
    service_counts = dict.fromkeys(template.VARIANTS, 0)
    # the synchronous run's waves, as the batcher launched them, to hold
    # against the plain version below
    sync_waves = []
    launch_plan_rounds = multi.launch_plan_rounds

    def recorded(plan, round_samples, n_rounds, key, *, start_rounds):
        where, outputs = launch_plan_rounds(plan, round_samples, n_rounds, key,
                                            start_rounds=start_rounds)
        sync_waves.append((plan, round_samples, n_rounds, key,
                           dict(start_rounds), outputs))
        return where, outputs

    for label, extra in (("synchronous", ["--state-dir", state]),
                         ("pipelined", ["--thread"]),
                         ("restarted", ["--state-dir", state])):
        template.reset_kernel_launch_count()
        multi.launch_plan_rounds = recorded if label == "synchronous" else launch_plan_rounds
        try:
            out = serve_integrals.main(base_args + extra)
        finally:
            multi.launch_plan_rounds = launch_plan_rounds
        torch.cuda.synchronize()
        counts = variant_counts({"fused_mc_rounds": label != "restarted",
                                 "fused_mc_compactified": label != "restarted"},
                                f"service ({label})")
        for k, v in counts.items():
            service_counts[k] += v
        waves = out["stats"].waves
        digest = served_digest(out["results"])
        runs[label] = out
        print(f"service config 1 ({label}): {len(out['results'])} requests in "
              f"{out['seconds']:.4f} s -> {len(out['results']) / out['seconds']:.1f} "
              f"requests/s; {out['launches']} launches in {waves} waves "
              f"({out['launches'] / max(waves, 1):.2f} per wave against at most "
              f"{n_dims} buckets per wave); {out['fallback_rounds']} chunked "
              f"fallback rounds; {out['hits']} pure cache hits; digest {digest[:16]}")
        check(out["fallback_rounds"] == 0, f"{label}: chunked fallback rounds")
        check(out["launches"] <= n_dims * max(waves, 1),
              f"{label}: more launches than buckets per wave")
        out["digest"] = digest
    check(runs["restarted"]["launches"] == 0, "the warm replay launched kernels")
    check(runs["restarted"]["hits"] == len(runs["restarted"]["results"]),
          "the warm replay was not served from the cache")
    check(len({r["digest"] for r in runs.values()}) == 1,
          "synchronous, pipelined and restarted digests differ")
    print("service config 1: synchronous = pipelined = restarted digests "
          f"({runs['synchronous']['digest'][:16]}), warm replay 0 launches")
    # each launch of the synchronous run (R-round, compactified blocks at
    # the service's shapes) against the plain version with the same
    # rounds, window starts and transform columns, round by round
    n_compact = 0
    for plan_w, n_round, n_r, key_w, starts, outputs in sync_waves:
        scal = template.pack_scalars(key_w, 0, n_round, round_stride=n_round)
        for b, k_out in zip(plan_w.buckets, outputs):
            p_out = template.fused_mc_plain(
                scal, b.fn_ids, b.packed, b.lo, b.hi, b.block_forms, dim=b.dim,
                n_sample_blocks=-(-n_round // template.S_BLK), n_rounds=n_r,
                round_base=multi._round_base_for(b, starts, n_round),
                block_tcols=b.block_tcols)
            compact = bool((b.block_tcols >= 0).any())
            n_compact += compact and n_r > 1
            for r in range(n_r):
                err = compare_estimates(b, k_out[r:r + 1], p_out[r:r + 1], n_round)
                if compact:
                    compact_err = max(compact_err, err)
                else:
                    rounds_err = max(rounds_err, err)
    print(f"service config 1: {sum(len(w[5]) for w in sync_waves)} launches of "
          f"the synchronous run ({n_compact} with R > 1 and compactified "
          f"blocks; R in {sorted({w[2] for w in sync_waves})}) held against "
          f"the plain version")
    check(n_compact > 0,
          "the synchronous run launched no R > 1 compactified bucket")
    print("service config 1, traced synchronous run: " + traced_split(
        serve_integrals.demo_workload(64, n_fn=8, n_samples=16384),
        round_samples=8192, max_rounds_per_wave=8))

    # -- 12. the service at full width: Fig.-1 as requests ------------------
    from repro_torch.service import IntegrationEngine, IntegrationRequest
    reqs = [IntegrationRequest.make([f], n_samples=N_FULL) for f in spec.families]
    engine = IntegrationEngine(round_samples=FULL_ROUND, device="cuda",
                               max_rounds_per_wave=FULL_R)
    template.reset_kernel_launch_count()
    t0 = time.perf_counter()
    tickets = [engine.submit(r) for r in reqs]
    while engine.step():
        pass
    full = [engine.poll(t) for t in tickets]
    torch.cuda.synchronize()
    full_wall = time.perf_counter() - t0
    full_counts = variant_counts({"fused_mc_rounds": True}, "service config 2")
    full_launches = template.kernel_launch_count()
    for k, v in full_counts.items():
        service_counts[k] += v
    offsets = [e.fn_offset for e in (engine.cache.get(c) for c in
               (r.stream_ids[0] for r in full))]
    engine.close()
    print(f"service config 2: {spec.n_fn_total} integrands x {N_FULL} samples in "
          f"{engine.stats.waves} waves, {full_launches} kernel launches, "
          f"{engine.batcher.fallback_rounds} fallback rounds, {full_wall:.4f} s wall; "
          f"fn offsets {'=' if offsets == spec.offsets() else '!='} spec.offsets()")
    check(full_launches == 6, f"expected 6 launches, got {full_launches}")
    check(offsets == spec.offsets(), "the cache placed the families elsewhere")
    # the same counters through evaluate: one 2^20-sample round per family
    ref = ZMCMultiFunctions(spec, n_samples=N_FULL, seed=0, use_kernel=True,
                            device="cuda").evaluate(num_trials=1)
    got_m = np.concatenate([r.means for r in full])
    got_s = np.concatenate([r.stderrs for r in full])
    d_mean = float(np.max(np.abs(got_m - ref.means[0]) / ref.stderrs[0]))
    d_se = float(np.max(np.abs(got_s - ref.stderrs[0]) / ref.stderrs[0]))
    print(f"service config 2 vs evaluate(n_samples={N_FULL}): max |d mean| "
          f"{d_mean:.3g}, max |d stderr| {d_se:.3g} standard errors "
          f"(limit {EST_TOL})")
    check(d_mean <= EST_TOL and d_se <= EST_TOL,
          "service config 2 disagrees with evaluate")
    # one wave's launches (R = 8 rounds of 65536 per family), timed alone
    fplan = multi.plan_spec(spec)
    start = {i: 0 for i in range(len(spec.families))}
    ev0.record()
    for _ in range(TIMING_REPS):
        multi.launch_plan_rounds(fplan, FULL_ROUND, FULL_R, engine.key,
                                 start_rounds=start)
    ev1.record()
    torch.cuda.synchronize()
    wave_ms = ev0.elapsed_time(ev1) / TIMING_REPS
    _, k_wave = multi.launch_plan_rounds(fplan, FULL_ROUND, FULL_R, engine.key,
                                         start_rounds=start)
    ev0.record()
    p_wave = [template.fused_mc_plain(
        template.pack_scalars(engine.key, 0, FULL_ROUND, round_stride=FULL_ROUND),
        b.fn_ids, b.packed, b.lo, b.hi, b.block_forms, dim=b.dim,
        n_sample_blocks=FULL_ROUND // template.S_BLK, n_rounds=FULL_R,
        round_base=multi._round_base_for(b, start, FULL_ROUND),
        block_tcols=b.block_tcols) for b in fplan.buckets]
    ev1.record()
    torch.cuda.synchronize()
    wave_plain_ms = ev0.elapsed_time(ev1)
    for b, k_out, p_out in zip(fplan.buckets, k_wave, p_wave):
        # the wave's R rounds folded, as the cache folds them
        rounds_err = max(rounds_err, compare_estimates(
            b, k_out.sum(0, keepdim=True), p_out.sum(0, keepdim=True),
            FULL_ROUND * FULL_R))
    w_draws = sum(f.n_fn * f.dim for f in spec.families) * FULL_ROUND * FULL_R
    w_values = spec.n_fn_total * FULL_ROUND * FULL_R
    w_op = op_bound_ms(w_draws, w_values, n_sm, clock_hz)
    wave_bound = max(w_op.values())
    host_share = 1 - engine.stats.waves * wave_ms / (full_wall * 1e3)
    print("service config 2, traced synchronous run: " + traced_split(
        reqs, round_samples=FULL_ROUND, max_rounds_per_wave=FULL_R))
    print(f"service config 2: kernel {wave_ms:.3f} ms per wave (3 launches, R={FULL_R}, "
          f"{w_draws:.4g} draws), plain {wave_plain_ms:.1f} ms, bound "
          f"{wave_bound:.3f} ms (kernel at {100 * wave_bound / wave_ms:.1f}%); wall "
          f"{1e3 * full_wall / max(engine.stats.waves, 1):.3f} ms per wave, host share "
          f"{100 * host_share:.1f}% of the wall; on {card}")

    # -- 13. device Sobol points and shifts, bit for bit --------------------
    from repro_torch.core import sobol
    n = 1 << 17
    i = torch.arange(n, dtype=torch.int64, device=device)
    idx = (2**32 - n // 4 + i * 3) & rng.MASK32             # crosses 2^32
    fid = (i * 2654435761) % (1 << 24)
    k0, k1 = rng.fold_key(2025, 3)
    bad = 0
    for dim in range(1, sobol.MAX_DIM + 1):
        pts, shs = template.sobol_cuda(k0, k1, idx, fid, dim)
        d = torch.arange(dim, device=device)
        want_sh = rng.random_bits(
            k0, k1, torch.full((1,), sobol.SHIFT_C0, device=device),
            rng.counter_c1(fid[:, None], d[None, :]))
        bad += int((pts != sobol.sobol_bits(idx, dim)).sum())
        bad += int((shs != want_sh).sum())
    torch.cuda.synchronize()
    print(f"device sobol_point / sobol_shift vs core.sobol: {bad} differences over "
          f"{n} indices x dims 1-{sobol.MAX_DIM} (indices from {2**32 - n // 4}, "
          f"crossing 2^32)")
    check(bad == 0, f"device Sobol points or shifts differ in {bad} words")
    # the points as pass 1 walks them: 256 threads, each along its stride-256
    # run, every run crossing 2^32
    start = 2**32 - 256 * 200 - 99
    walk_idx = (start + i[:256 * 400]) & rng.MASK32
    bad = sum(int((template.sobol_walk_cuda(start, walk_idx.numel(), dim, device)
                   != sobol.sobol_bits(walk_idx, dim)).sum())
              for dim in range(1, sobol.MAX_DIM + 1))
    print(f"device walked Sobol points (sobol_walk, 256 runs of stride 256 crossing "
          f"2^32) vs core.sobol: {bad} differences over {walk_idx.numel()} indices x "
          f"dims 1-{sobol.MAX_DIM}")
    check(bad == 0, f"walked Sobol points differ in {bad} words")

    # -- 14. Fig.-1 evaluate with the Sobol sampler --------------------------
    splan = multi.plan_spec(spec, sampler="sobol")
    check(splan.unfused == () and splan.n_launches == 3,
          f"Sobol plan: {splan.n_launches} buckets, unfused {splan.unfused}")
    key = rng.fold_key(0, 0)
    sobol_err = 0.0
    for b in splan.buckets:
        kw = dict(sampler="sobol", dirvecs=b.dirvecs)
        k_out = launch_bucket(template.fused_mc_cuda, b, N_CHECK, key, **kw)
        k_again = launch_bucket(template.fused_mc_cuda, b, N_CHECK, key, **kw)
        p_out = launch_bucket(template.fused_mc_plain, b, N_CHECK, key, sampler="sobol")
        torch.cuda.synchronize()
        sobol_err = max(sobol_err, compare_sums(b, k_out, p_out, N_CHECK))
        d1 = hashlib.sha256(k_out.cpu().numpy().tobytes()).hexdigest()
        d2 = hashlib.sha256(k_again.cpu().numpy().tobytes()).hexdigest()
        print(f"Sobol bucket d{b.dim} at N={N_CHECK}: repeat sha256 {d1[:16]} "
              f"{d2[:16]} {'equal' if d1 == d2 else 'DIFFER'}")
        check(d1 == d2, f"Sobol d{b.dim}: repeated launches differ")
        # R = 4 rounds at other window depths, one crossing 2^32
        n_blocks = b.fn_ids.shape[0] // template.F_BLK
        base = torch.tensor([(j * 37 * N_ROUND) & rng.MASK32 for j in range(n_blocks)],
                            dtype=torch.int64)
        base[n_blocks // 2] = 2**32 - 3 * N_ROUND // 2
        ops = (b.fn_ids, b.packed, b.lo, b.hi, b.block_forms)
        rkw = dict(dim=b.dim, n_sample_blocks=N_ROUND // template.S_BLK,
                   round_base=base, sampler="sobol")
        r_out = template.fused_mc_cuda(
            template.pack_scalars(key, 0, N_ROUND, round_stride=N_ROUND), *ops,
            n_rounds=ROUNDS, **rkw)
        same = 0
        for r in range(ROUNDS):
            one = template.fused_mc_cuda(
                template.pack_scalars(key, r * N_ROUND, N_ROUND), *ops, **rkw)
            same += (hashlib.sha256(r_out[r].cpu().numpy().tobytes()).digest()
                     == hashlib.sha256(one[0].cpu().numpy().tobytes()).digest())
        print(f"Sobol bucket d{b.dim}: R={ROUNDS} launch: {same}/{ROUNDS} rounds "
              f"sha256-equal to single-round launches (one window crossing 2^32)")
        check(same == ROUNDS, f"Sobol d{b.dim}: a round differs from its single-round launch")

    szmc = ZMCMultiFunctions(spec, n_samples=N_MAIN, seed=0, use_kernel=True,
                             sampler="sobol", device="cuda")
    template.reset_launch_count()
    template.reset_kernel_launch_count()
    t0 = time.perf_counter()
    sres = szmc.evaluate(num_trials=TRIALS)
    torch.cuda.synchronize()
    swall = time.perf_counter() - t0
    s_launches = template.kernel_launch_count()
    sobol_counts = variant_counts({"fused_mc": True, "fused_mc_sobol": True},
                                  "Sobol evaluate path")
    print(f"Sobol evaluate(num_trials={TRIALS}) at N={N_MAIN}: {swall / TRIALS:.4f} s "
          f"per trial (wall); {s_launches} kernel launches")
    check(s_launches == splan.n_launches * TRIALS,
          f"expected {splan.n_launches * TRIALS} Sobol launches, got {s_launches}")
    check(sobol_counts["fused_mc_sobol"] == s_launches, "a Sobol launch ran as MC")
    check(bool(np.isfinite(sres.means).all() and np.isfinite(sres.stderrs).all()),
          "non-finite Sobol estimates")
    s_fbar, s_dfn = sres.trial_mean, sres.trial_std
    s_cover = float(np.mean(np.abs(s_fbar[:700] - exact_h) <= 2 * s_dfn[:700]))
    ratio = dfn / np.maximum(s_dfn, 1e-30)
    print(f"Sobol harmonic 2-sigma coverage vs harmonic_analytic: {s_cover:.4f} (700 "
          f"integrands); median MC-to-Sobol ratio of trial_std over the "
          f"{spec.n_fn_total} integrals {float(np.median(ratio)):.2f} (harmonics "
          f"{float(np.median(ratio[:700])):.2f})")
    check(s_cover >= 0.85, f"Sobol harmonic coverage {s_cover} < 0.85")

    ev0.record()
    for _ in range(TIMING_REPS):
        sk_outs = [launch_bucket(template.fused_mc_cuda, b, N_MAIN, key,
                                 sampler="sobol", dirvecs=b.dirvecs)
                   for b in splan.buckets]
    ev1.record()
    torch.cuda.synchronize()
    sobol_ms = ev0.elapsed_time(ev1) / TIMING_REPS
    ev0.record()
    sp_outs = [launch_bucket(template.fused_mc_plain, b, N_MAIN, key, sampler="sobol")
               for b in splan.buckets]
    ev1.record()
    torch.cuda.synchronize()
    sobol_plain_ms = ev0.elapsed_time(ev1)
    for b, k_out, p_out in zip(splan.buckets, sk_outs, sp_outs):
        sobol_err = max(sobol_err, compare_estimates(b, k_out, p_out, N_MAIN))
    s_pts = distinct_point_dims(splan, N_MAIN)
    s_built = built_point_dims(splan, N_MAIN)
    s_op = sobol_op_bound_ms(draws, values, s_pts, n_sm, clock_hz)
    sobol_bound = max(s_op.values())
    print(f"Sobol trial (3 launches, {draws:.4g} draws, {s_pts:.4g} distinct point "
          f"dims, {s_built:.4g} walked, once per 16-function block): kernel "
          f"{sobol_ms:.3f} ms, plain {sobol_plain_ms:.1f} ms, bound {sobol_bound:.3f} ms "
          f"(kernel at {100 * sobol_bound / sobol_ms:.1f}% of it): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in s_op.items())
          + f"; MC kernel {kernel_ms:.3f} ms; on {card}")
    print("Sobol pass 1: " + pass1_report(built["zmc_fused_mc"]["path"],
                                          pass1["<0,true,true>"], "<0,true,true>")
          + f"; kernel {sobol_ms:.3f} ms against its bound {sobol_bound:.3f} ms")

    # -- 15. service configuration 3: a parameter sweep at full width --------
    from repro_torch.core.integrand import MultiFunctionSpec, harmonic_family
    from repro_torch.service import SweepRequest
    a_vals = np.linspace(*SWEEP_A).astype(np.float32)
    b_vals = np.linspace(*SWEEP_B).astype(np.float32)
    grid = {"a": a_vals, "b": b_vals}
    tmpl = harmonic_family(1, 4)
    n_pts = len(a_vals) * len(b_vals)
    swept = {}                          # per sampler: its kernels-line numbers
    for sampler in ("mc", "sobol"):
        swept_err = 0.0
        engine = IntegrationEngine(round_samples=FULL_ROUND, device="cuda",
                                   max_rounds_per_wave=FULL_R)
        waves_rec = []

        def recorded_sweep(plan, round_samples, n_rounds, key, *, start_rounds):
            where, outputs = launch_plan_rounds(plan, round_samples, n_rounds, key,
                                                start_rounds=start_rounds)
            waves_rec.append((plan, round_samples, n_rounds, key, dict(start_rounds),
                              outputs))
            return where, outputs

        multi.launch_plan_rounds = recorded_sweep
        template.reset_kernel_launch_count()
        try:
            t0 = time.perf_counter()
            ticket = engine.submit(SweepRequest.make(tmpl, grid, n_samples=N_FULL,
                                                     sampler=sampler))
            while engine.step():
                pass
            sres3 = engine.poll(ticket)
            torch.cuda.synchronize()
            sweep_wall = time.perf_counter() - t0
        finally:
            multi.launch_plan_rounds = launch_plan_rounds
        counts = variant_counts({"fused_mc_rounds": True, "fused_mc_swept": True,
                                 "fused_mc_sobol": sampler == "sobol"},
                                f"service config 3 ({sampler})")
        n_launch = template.kernel_launch_count()
        waves = engine.stats.waves
        print(f"service config 3 ({sampler}): {n_pts} points in "
              f"{len(sres3.stream_ids)} slices x {N_FULL} samples: {n_launch} kernel "
              f"launches in {waves} waves (at most 1 bucket per wave), "
              f"{engine.batcher.fallback_rounds} fallback rounds, {sweep_wall:.4f} s "
              f"wall, {1e3 * sweep_wall / max(waves, 1):.3f} ms per wave")
        check(sres3.complete and sres3.grid_shape == (len(a_vals), len(b_vals)),
              "config 3: sweep result incomplete or misshapen")
        check(bool(np.isfinite(sres3.means).all() and (sres3.stderrs > 0).all()),
              "config 3: non-finite estimates")
        check(n_launch <= waves, "config 3: more launches than buckets per wave")
        check(engine.batcher.fallback_rounds == 0, "config 3: chunked fallback rounds")
        check(len(sres3.stream_ids) == n_pts // SWEEP_SLICE, "config 3: slice count")
        # each launch against the plain version with the same rounds, window
        # starts and sweep pairs, round by round
        for plan_w, n_round, n_r, key_w, starts, outputs in waves_rec:
            scal = template.pack_scalars(key_w, 0, n_round, round_stride=n_round)
            for b, k_out in zip(plan_w.buckets, outputs):
                check(b.block_sweep is not None, "config 3: a bucket without sweep pairs")
                p_out = template.fused_mc_plain(
                    scal, b.fn_ids, b.packed, b.lo, b.hi, b.block_forms, dim=b.dim,
                    n_sample_blocks=-(-n_round // template.S_BLK), n_rounds=n_r,
                    round_base=multi._round_base_for(b, starts, n_round),
                    block_sweep=b.block_sweep, sampler=sampler)
                for r in range(n_r):
                    swept_err = max(swept_err, compare_estimates(
                        b, k_out[r:r + 1], p_out[r:r + 1], n_round))
        # slice 0 of the first wave against its 64 points as per-point
        # families, with the same fn ids, window starts and rounds
        plan_w, n_round, n_r, key_w, starts, outputs = waves_rec[0]
        (b,) = plan_w.buckets
        off = engine.cache.get(sres3.stream_ids[0]).fn_offset
        sl = next(x for x in b.slices if int(b.fn_ids[x.row_start]) == off)
        pts_spec = MultiFunctionSpec.from_families([
            harmonic_family(1, 4, a=a_vals[j // len(b_vals)][None],
                            b=b_vals[j % len(b_vals)][None])
            for j in range(SWEEP_SLICE)]).to(device)
        pts_plan = multi.plan_spec(pts_spec, sampler=sampler,
                                   fn_offsets=[off + j for j in range(SWEEP_SLICE)])
        _, pts_out = launch_plan_rounds(
            pts_plan, n_round, n_r, key_w,
            start_rounds={j: starts[sl.family_index] for j in range(SWEEP_SLICE)})
        equal = 0
        for j, ps in enumerate(pts_plan.buckets[0].slices):
            got = outputs[0][:, sl.row_start + j].cpu().numpy().tobytes()
            want = pts_out[0][:, ps.row_start].cpu().numpy().tobytes()
            equal += hashlib.sha256(got).digest() == hashlib.sha256(want).digest()
        print(f"service config 3 ({sampler}): slice 0's {SWEEP_SLICE} points, all "
              f"{n_r} rounds: {equal}/{SWEEP_SLICE} sha256-equal to per-point "
              f"families launched with the same fn ids and windows")
        check(equal == SWEEP_SLICE, f"config 3 ({sampler}): a swept point differs "
                                    f"from its per-point launch")
        # one wave's launch, timed alone
        start0 = {x.family_index: 0 for x in b.slices}
        ev0.record()
        for _ in range(TIMING_REPS):
            launch_plan_rounds(plan_w, n_round, n_r, key_w, start_rounds=start0)
        ev1.record()
        torch.cuda.synchronize()
        sweep_ms = ev0.elapsed_time(ev1) / TIMING_REPS
        ev0.record()
        template.fused_mc_plain(
            template.pack_scalars(key_w, 0, n_round, round_stride=n_round),
            b.fn_ids, b.packed, b.lo, b.hi, b.block_forms, dim=b.dim,
            n_sample_blocks=-(-n_round // template.S_BLK), n_rounds=n_r,
            round_base=multi._round_base_for(b, start0, n_round),
            block_sweep=b.block_sweep, sampler=sampler)
        ev1.record()
        torch.cuda.synchronize()
        sweep_plain_ms = ev0.elapsed_time(ev1)
        w3_values = float(n_pts) * n_round * n_r
        w3_draws = w3_values * b.dim
        bound3 = max((op_bound_ms(w3_draws, w3_values, n_sm, clock_hz)
                      if sampler == "mc" else
                      sobol_op_bound_ms(w3_draws, w3_values, distinct_point_dims(
                          plan_w, n_round, [multi._round_base_for(b, start0, n_round)],
                          n_r, n_round), n_sm, clock_hz)).values())
        swept[sampler] = dict(launches=counts["fused_mc_swept"], max_abs_err=swept_err,
                              ms=sweep_ms, plain_ms=sweep_plain_ms, bound_ms=bound3)
        host3 = 1 - waves * sweep_ms / (1e3 * sweep_wall)
        print(f"service config 3 ({sampler}): kernel {sweep_ms:.3f} ms per "
              f"wave (1 launch, R={n_r}, {w3_draws:.4g} draws), plain "
              f"{sweep_plain_ms:.1f} ms, bound {bound3:.3f} ms (kernel at "
              f"{100 * bound3 / sweep_ms:.1f}%); host share "
              f"{100 * host3:.1f}% of the wall; on {card}")
        # an overlapping sweep: the prefix grid a[:16] x b, 8 aligned slices
        template.reset_kernel_launch_count()
        t_over = engine.submit(SweepRequest.make(
            tmpl, {"a": a_vals[:SWEEP_PREFIX], "b": b_vals}, n_samples=N_FULL,
            sampler=sampler))
        while engine.step():
            pass
        over = engine.poll(t_over)
        torch.cuda.synchronize()
        over_launches = template.kernel_launch_count()
        same_prefix = np.array_equal(over.means,
                                     sres3.means[:SWEEP_PREFIX * len(b_vals)])
        print(f"service config 3 ({sampler}): overlapping sweep a[:{SWEEP_PREFIX}] x b "
              f"({len(over.stream_ids)} slices): {over_launches} launches, served "
              f"from cache {over.served_from_cache}, means equal to the full sweep's "
              f"prefix: {same_prefix}")
        check(over_launches == 0 and over.served_from_cache and same_prefix,
              f"config 3 ({sampler}): the overlapping sweep was not a free cache hit")
        engine.close()
        print(f"service config 3 ({sampler}), traced synchronous run: " + traced_split(
            [SweepRequest.make(tmpl, grid, n_samples=N_FULL, sampler=sampler)],
            round_samples=FULL_ROUND, max_rounds_per_wave=FULL_R))

    # -- 16. service configuration 2 with the Sobol sampler ------------------
    sreqs = [IntegrationRequest.make([f], n_samples=N_FULL, sampler="sobol")
             for f in spec.families]
    engine = IntegrationEngine(round_samples=FULL_ROUND, device="cuda",
                               max_rounds_per_wave=FULL_R)
    template.reset_kernel_launch_count()
    t0 = time.perf_counter()
    tickets = [engine.submit(r) for r in sreqs]
    while engine.step():
        pass
    sfull = [engine.poll(t) for t in tickets]
    torch.cuda.synchronize()
    sfull_wall = time.perf_counter() - t0
    variant_counts({"fused_mc_rounds": True, "fused_mc_sobol": True},
                   "service config 2 (sobol)")
    s2_launches = template.kernel_launch_count()
    engine.close()
    sref = ZMCMultiFunctions(spec, n_samples=N_FULL, seed=0, use_kernel=True,
                             sampler="sobol", device="cuda").evaluate(num_trials=1)
    got_m = np.concatenate([r.means for r in sfull])
    got_s = np.concatenate([r.stderrs for r in sfull])
    d_mean = float(np.max(np.abs(got_m - sref.means[0]) / sref.stderrs[0]))
    d_se = float(np.max(np.abs(got_s - sref.stderrs[0]) / sref.stderrs[0]))
    print(f"service config 2 (sobol): {s2_launches} kernel launches in "
          f"{engine.stats.waves} waves, {engine.batcher.fallback_rounds} fallback "
          f"rounds, {sfull_wall:.4f} s wall; vs evaluate(sampler='sobol', "
          f"n_samples={N_FULL}): max |d mean| {d_mean:.3g}, max |d stderr| "
          f"{d_se:.3g} standard errors (limit {EST_TOL})")
    check(s2_launches == 6 and engine.batcher.fallback_rounds == 0,
          "service config 2 (sobol): expected 6 launches and no fallback")
    check(d_mean <= EST_TOL and d_se <= EST_TOL,
          "service config 2 (sobol) disagrees with evaluate")

    # -- 17. adapted families: VEGAS grids through the fused kernel ---------
    t0 = time.perf_counter()
    aspec, uspec, a_exact = adapted_spec(device)
    torch.cuda.synchronize()
    print(f"adapted spec: {aspec.n_fn_total} integrands in {len(aspec.families)} "
          f"families ({', '.join(f.name for f in aspec.families)}), grids fitted on "
          f"the card in {time.perf_counter() - t0:.2f} s ({ADAPT_EPOCHS} epochs of "
          f"{ADAPT_PILOT}-sample pilots, {ADAPT_BINS} bins per axis)")
    adapted = {}                 # per sampler: its kernels-line numbers and result
    a_offs = aspec.offsets()
    for sampler in ("mc", "sobol"):
        aplan = multi.plan_spec(aspec, sampler=sampler)
        check(aplan.unfused == () and aplan.n_launches == 3,
              f"adapted plan ({sampler}): {aplan.n_launches} buckets, unfused "
              f"{aplan.unfused}")
        key = rng.fold_key(0, 0)
        a_err = 0.0
        for b in aplan.buckets:
            check(bool((b.block_adapt[0] >= 0).all()), "a bucket block without its grid")
            kw = dict(block_tcols=b.block_tcols, block_adapt=b.block_adapt,
                      sampler=sampler)
            k_out = launch_bucket(template.fused_mc_cuda, b, N_CHECK, key,
                                  block_meta=b.block_meta, dirvecs=b.dirvecs, **kw)
            k_again = launch_bucket(template.fused_mc_cuda, b, N_CHECK, key,
                                    block_meta=b.block_meta, dirvecs=b.dirvecs, **kw)
            p_out = launch_bucket(template.fused_mc_plain, b, N_CHECK, key, **kw)
            torch.cuda.synchronize()
            a_err = max(a_err, compare_sums(b, k_out, p_out, N_CHECK))
            same = sha256_of(k_out) == sha256_of(k_again)
            # R = 4 rounds at other window depths, one crossing 2^32
            n_blocks = b.fn_ids.shape[0] // template.F_BLK
            base = torch.tensor([(j * 37 * N_ROUND) & rng.MASK32
                                 for j in range(n_blocks)], dtype=torch.int64)
            base[n_blocks // 2] = 2**32 - 3 * N_ROUND // 2
            ops = (b.fn_ids, b.packed, b.lo, b.hi, b.block_forms)
            rkw = dict(kw, dim=b.dim, n_sample_blocks=N_ROUND // template.S_BLK,
                       round_base=base, block_meta=b.block_meta, dirvecs=b.dirvecs)
            r_out = template.fused_mc_cuda(
                template.pack_scalars(key, 0, N_ROUND, round_stride=N_ROUND), *ops,
                n_rounds=ROUNDS, **rkw)
            rounds_same = sum(
                sha256_of(r_out[r]) == sha256_of(template.fused_mc_cuda(
                    template.pack_scalars(key, r * N_ROUND, N_ROUND), *ops, **rkw)[0])
                for r in range(ROUNDS))
            print(f"adapted bucket d{b.dim} ({sampler}): repeat sha256 "
                  f"{'equal' if same else 'DIFFER'}; R={ROUNDS} launch: {rounds_same}/"
                  f"{ROUNDS} rounds sha256-equal to single-round launches (one window "
                  f"crossing 2^32)")
            check(same, f"adapted d{b.dim} ({sampler}): repeated launches differ")
            check(rounds_same == ROUNDS,
                  f"adapted d{b.dim} ({sampler}): a round differs from its single-round launch")

        azmc = ZMCMultiFunctions(aspec, n_samples=N_MAIN, seed=0, use_kernel=True,
                                 sampler=sampler, device="cuda")
        template.reset_launch_count()
        template.reset_kernel_launch_count()
        t0 = time.perf_counter()
        ares = azmc.evaluate(num_trials=TRIALS)
        torch.cuda.synchronize()
        awall = time.perf_counter() - t0
        a_launches = template.kernel_launch_count()
        a_counts = variant_counts({"fused_mc": True, "fused_mc_adapted": True,
                                   "fused_mc_compactified": True,
                                   "fused_mc_sobol": sampler == "sobol"},
                                  f"adapted evaluate path ({sampler})")
        print(f"adapted evaluate(num_trials={TRIALS}, sampler={sampler!r}) at N={N_MAIN}: "
              f"{awall / TRIALS:.4f} s per trial (wall); {a_launches} kernel launches")
        check(a_launches == aplan.n_launches * TRIALS,
              f"expected {aplan.n_launches * TRIALS} adapted launches, got {a_launches}")
        check(a_counts["fused_mc_adapted"] == a_launches, "an adapted launch ran no grid")
        check(bool(np.isfinite(ares.means).all() and np.isfinite(ares.stderrs).all()),
              "non-finite adapted estimates")
        pull = np.abs(ares.trial_mean - a_exact) / np.maximum(ares.trial_std, 1e-30)
        a_cover = float(np.mean(pull <= 2))
        print(f"adapted ({sampler}) 2-sigma coverage vs exact: {a_cover:.4f} over "
              f"{aspec.n_fn_total} integrals; "
              + ", ".join(f"{f.name} {float(np.mean(pull[o:o + f.n_fn] <= 2)):.4f}"
                          for f, o in zip(aspec.families, a_offs)))
        check(a_cover >= 0.85, f"adapted ({sampler}) coverage {a_cover} < 0.85")

        kw_of = {b.name: dict(block_tcols=b.block_tcols, block_adapt=b.block_adapt,
                              sampler=sampler) for b in aplan.buckets}
        ev0.record()
        for _ in range(TIMING_REPS):
            ak_outs = [launch_bucket(template.fused_mc_cuda, b, N_MAIN, key,
                                     block_meta=b.block_meta, dirvecs=b.dirvecs,
                                     **kw_of[b.name]) for b in aplan.buckets]
        ev1.record()
        torch.cuda.synchronize()
        a_ms = ev0.elapsed_time(ev1) / TIMING_REPS
        ev0.record()
        ap_outs = [launch_bucket(template.fused_mc_plain, b, N_MAIN, key, **kw_of[b.name])
                   for b in aplan.buckets]
        ev1.record()
        torch.cuda.synchronize()
        a_plain_ms = ev0.elapsed_time(ev1)
        for b, k_out, p_out in zip(aplan.buckets, ak_outs, ap_outs):
            a_err = max(a_err, compare_estimates(b, k_out, p_out, N_MAIN))
        a_draws = float(sum(f.n_fn * f.dim for f in aspec.families)) * N_MAIN
        a_values = float(aspec.n_fn_total) * N_MAIN
        a_tan = float(aspec.families[2].n_fn * aspec.families[2].dim) * N_MAIN
        if sampler == "mc":
            a_op = op_bound_ms(a_draws, a_values, n_sm, clock_hz, tan_axes=a_tan,
                               adapt_axes=a_draws, adapt_values=a_values)
        else:
            a_op = sobol_op_bound_ms(a_draws, a_values, distinct_point_dims(aplan, N_MAIN),
                                     n_sm, clock_hz, tan_axes=a_tan, adapt_axes=a_draws,
                                     adapt_values=a_values)
        a_bound = max(a_op.values())
        print(f"adapted trial ({sampler}, 3 launches, {a_draws:.4g} draws through a grid, "
              f"{a_tan:.4g} of them then through the tan map): kernel {a_ms:.3f} ms, "
              f"plain {a_plain_ms:.1f} ms, bound {a_bound:.3f} ms (kernel at "
              f"{100 * a_bound / a_ms:.1f}% of it): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in a_op.items()) + f"; on {card}")
        inst = "<2,false,true>" if sampler == "mc" else "<2,true,true>"
        print(f"adapted pass 1 ({sampler}): "
              + pass1_report(built["zmc_fused_mc"]["path"], pass1[inst], inst)
              + f"; kernel {a_ms:.3f} ms against its bound {a_bound:.3f} ms")
        adapted[sampler] = dict(launches=a_counts["fused_mc_adapted"], max_abs_err=a_err,
                                ms=a_ms, plain_ms=a_plain_ms, bound_ms=a_bound,
                                res=ares)
    ures = ZMCMultiFunctions(uspec, n_samples=N_MAIN, seed=0, use_kernel=True,
                             device="cuda").evaluate(num_trials=TRIALS)
    ratio = ures.trial_std / np.maximum(adapted["mc"]["res"].trial_std, 1e-30)
    print(f"unadapted-to-adapted trial_std ratio (MC, {TRIALS} trials at N={N_MAIN}): "
          f"median {float(np.median(ratio)):.2f} over {aspec.n_fn_total} integrals; "
          + ", ".join(f"{f.name} {float(np.median(ratio[o:o + f.n_fn])):.2f}"
                      for f, o in zip(uspec.families, a_offs)))
    check(float(np.median(ratio)) > 1.0, "the grids did not lower the trial spread")

    # -- 18. adaptive requests through the service (BENCH_10's protocol) ----
    import shutil
    from repro_torch.core import genz
    from repro_torch.core.integrand import gaussian_family
    from repro_torch.obs import Observability
    from repro_torch.service.api import IntegrationClient

    def bench10_engine(state_dir=None):
        return IntegrationEngine(state_dir=state_dir, device="cuda",
                                 obs=Observability.enabled(), **BENCH10_KW)

    def solve(fams, target, adaptive):
        eng = bench10_engine()
        t0 = time.perf_counter()
        res = IntegrationClient(eng).integrate(fams, target_stderr=target,
                                               adaptive=adaptive)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        samples = int(sum(res.n_per_family))
        if adaptive:
            # every pilot charged: one per opened epoch plus at most one
            # frozen refit attempt per base stream, per function
            epochs = int(eng.obs.m["adapted_streams"].value())
            samples += ((epochs + len(fams)) * eng.adapt_pilot_samples
                        * sum(f.n_fn for f in fams))
        refits = int(eng.obs.m["grid_refits"].value())
        out = (res, samples, refits, dt, eng.stats.waves, eng.batcher.fallback_rounds)
        eng.close()
        return out

    corner, corner_exact = genz.corner_peak(2, 3, difficulty=4.0)
    gauss2 = gaussian_family(2, 2, sigma=[0.2, 0.35], lo=-np.inf, hi=np.inf)
    service_adapt = 0
    for name, fams, target, exact in (("genz_corner_3d", [corner], 5e-5, corner_exact),
                                      ("gaussian_r2", [gauss2], 5e-4, None)):
        f_res, f_n, _, f_dt, f_waves, _ = solve(fams, target, False)
        template.reset_kernel_launch_count()
        a_res, a_n, refits, a_dt, a_waves, a_fb = solve(fams, target, True)
        service_adapt += variant_counts({"fused_mc_adapted": True},
                                        f"adaptive service ({name})")["fused_mc_adapted"]
        ratio10 = f_n / max(a_n, 1)
        print(f"adaptive[{name}]: {f_n} fixed vs {a_n} adapted samples (pilots "
              f"charged) to stderr <= {target:g}: {ratio10:.1f}x fewer, {refits} "
              f"refit(s), {a_waves} waves ({f_waves} fixed), {a_fb} fallback rounds; "
              f"{f_dt:.3f} s vs {a_dt:.3f} s; means {a_res.means} (fixed "
              f"{f_res.means}, exact {exact})")
        check(ratio10 >= 5.0, f"{name}: {ratio10:.1f}x fewer samples, gate >= 5x")
        check(refits >= 1, f"{name}: no grid refit fired")
        check(bool(np.all(a_res.stderrs <= target)), f"{name}: target not met")
        if exact is not None:
            check(bool(np.all(np.abs(a_res.means - exact) <= 6 * a_res.stderrs + 1e-5)),
                  f"{name}: adapted estimate off its analytic value")
        check(bool(np.all(np.abs(a_res.means - f_res.means)
                          <= 6 * (a_res.stderrs + f_res.stderrs) + 1e-6)),
              f"{name}: adaptive and fixed paths disagree")
        check(a_fb == 0, f"{name}: chunked fallback rounds")
    # an adapted run abandoned after 3 waves and resumed from its state dir
    work = tempfile.mkdtemp(prefix="zmc_adapt_")
    eng = bench10_engine(os.path.join(work, "uninterrupted"))
    r_a = IntegrationClient(eng).integrate([corner], target_stderr=RESUME_TARGET,
                                           adaptive=True)
    waves_a = eng.stats.waves
    eng.close()
    eng = bench10_engine(os.path.join(work, "interrupted"))
    eng.submit(IntegrationRequest.make([corner], target_stderr=RESUME_TARGET,
                                       adaptive=True))
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    del eng                    # abandoned mid-flight: no close(), no snapshot
    eng = bench10_engine(os.path.join(work, "interrupted"))
    r_b = IntegrationClient(eng).integrate([corner], target_stderr=RESUME_TARGET,
                                           adaptive=True)
    eng.close()                # both of work's state dirs are audited at step 21
    same_ids = r_a.stream_ids == r_b.stream_ids
    same_bytes = (served_digest([r_a]) == served_digest([r_b])
                  and r_a.n_per_family == r_b.n_per_family)
    print(f"adaptive resume: uninterrupted run {waves_a} waves; abandoned after 3 "
          f"and resumed: stream ids {'equal' if same_ids else 'DIFFER'}, results "
          f"sha256 {'equal' if same_bytes else 'DIFFER'} ({served_digest([r_a])[:16]})")
    check(same_ids and same_bytes, "the resumed adapted run differs from the uninterrupted one")
    # the 1024-integrand batch as adaptive requests, one per family, each
    # target the family's largest standard error at one wave's samples
    # under the step-17 grids (epoch 3), so the engine's chain (epoch 1,
    # refits at its wave boundaries) needs about 2-4 waves
    se = adapted["mc"]["res"].stderrs.mean(0) * np.sqrt(N_MAIN / (FULL_R * FULL_ROUND))
    targets = [1.1 * float(se[o:o + f.n_fn].max()) for f, o in zip(uspec.families, a_offs)]
    raw = [genz.corner_peak(512, 3, difficulty=4.0)[0],
           genz.corner_peak(384, 4, difficulty=4.0)[0],
           gaussian_family(128, 2, sigma=np.linspace(0.2, 0.35, 128).astype(np.float32),
                           lo=-np.inf, hi=np.inf)]
    engine = IntegrationEngine(round_samples=FULL_ROUND, device="cuda",
                               max_rounds_per_wave=FULL_R, pipeline_waves=False,
                               obs=Observability.enabled())
    template.reset_kernel_launch_count()
    t0 = time.perf_counter()
    tickets = [engine.submit(IntegrationRequest.make([f], target_stderr=t, adaptive=True))
               for f, t in zip(raw, targets)]
    per_wave = []
    while True:
        before = template.kernel_launch_count()
        if not engine.step():
            break
        per_wave.append(template.kernel_launch_count() - before)
    batch = [engine.poll(t) for t in tickets]
    torch.cuda.synchronize()
    batch_wall = time.perf_counter() - t0
    b_counts = variant_counts({"fused_mc_adapted": True}, "adaptive batch")
    service_adapt += b_counts["fused_mc_adapted"]
    b_means = np.concatenate([r.means for r in batch])
    b_se = np.concatenate([r.stderrs for r in batch])
    b_cover = float(np.mean(np.abs(b_means - a_exact) <= 2 * b_se))
    print(f"adaptive batch: {aspec.n_fn_total} integrands as 3 requests (targets "
          + ", ".join(f"{t:.3g}" for t in targets) + f"): {engine.stats.waves} waves, "
          f"launches per wave {per_wave}, {int(engine.obs.m['grid_refits'].value())} "
          f"refits, {engine.batcher.fallback_rounds} fallback rounds, "
          f"{batch_wall:.3f} s wall; 2-sigma coverage vs exact {b_cover:.4f}; "
          f"{service_adapt} adapted launches over step 18")
    engine.close()
    check(all(r is not None and np.all(r.stderrs <= t) for r, t in zip(batch, targets)),
          "adaptive batch: a request unfinished or above its target")
    check(engine.batcher.fallback_rounds == 0, "adaptive batch: chunked fallback rounds")
    check(all(n <= 3 for n in per_wave), "adaptive batch: more launches than buckets in a wave")

    # -- 19. stratified sampling: the stratum-moments kernel and ZMCNormal ---
    import torch.nn.functional as F
    from repro_torch.core import stratified
    from repro_torch.core.normal import ZMCNormal
    from repro_torch.kernels.moments import ops as mops
    from repro_torch.kernels.moments import ref as mref
    gpeak, gpeak_exact = genz.gaussian_peak(1, NORMAL_DIM)
    gpeak = gpeak.to(device)

    def normal_fn(x):
        return gpeak.fn(x.reshape(1, -1, NORMAL_DIM), gpeak.params).reshape(x.shape[:-1])

    n0 = NORMAL_SPLITS ** NORMAL_DIM
    table = stratified.initial_grid(np.tile([[0.0, 1.0]], (NORMAL_DIM, 1)),
                                    NORMAL_SPLITS, n0, device=device)
    key = rng.fold_key(0, 0)
    slots = torch.arange(n0, device=device)
    u = rng.uniforms_for(*key, stratified.stratum_ids(slots, 0),
                         torch.arange(NORMAL_N_PER, device=device), NORMAL_DIM)
    lo, hi = table.boxes[:, None, :, 0], table.boxes[:, None, :, 1]
    vals = normal_fn(lo + u * (hi - lo))           # what eval_strata reduces
    del u
    vals = F.pad(vals, [0, 0, 0, -n0 % mops.R_BLK]).contiguous()

    def hold_moments(x, what):
        k1, k2 = mops.moments_cuda(x), mops.moments_cuda(x)
        torch.cuda.synchronize()
        check(sha256_of(k1) == sha256_of(k2), f"{what}: repeated launches differ")
        err = 0.0
        for label, w in (("plain", mops.moments_plain(x)), ("two-pass", mref.moments_ref(x))):
            d_count = float((k1[:, 0] - w[:, 0]).abs().max())
            d_mean = float((k1[:, 1] - w[:, 1]).abs().max())
            d_m2 = float(((k1[:, 2] - w[:, 2]).abs() / w[:, 2].abs().clamp(min=1e-30)).max())
            print(f"{what}: kernel vs {label}: count max|diff| {d_count:g}, mean "
                  f"{d_mean:.3g} (atol 1e-5), M2 relative {d_m2:.3g} (rtol 1e-4); "
                  f"repeat sha256 equal")
            check(d_count == 0 and d_mean <= 1e-5 and d_m2 <= 1e-4,
                  f"{what}: the kernel disagrees with the {label} version")
            err = max(err, d_mean, float((k1[:, 2] - w[:, 2]).abs().max()))
        return err

    def time_ms(fn, reps=20):
        """Device ms per call of ``fn``: the calls are queued behind a ~10 ms
        sleep kernel, so the host's launch overhead (tens of microseconds,
        as long as the kernel itself here) does not leave the card idle
        between them."""
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(int(0.01 * clock_hz))
        ev0.record()
        for _ in range(reps):
            fn()
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / reps

    mom_err = hold_moments(vals, f"stratum moments {tuple(vals.shape)}")
    mom = {"ms": time_ms(lambda: mops.moments_cuda(vals)),
           "plain_ms": time_ms(lambda: mops.moments_plain(vals), reps=3),
           "library_ms": time_ms(lambda: torch.var_mean(vals, dim=1, correction=0)),
           "bound_ms": (vals.numel() + 3 * vals.shape[0]) * 4 / HBM_BYTES_PER_S * 1e3}
    big = torch.randn(*BIG_MOMENTS, device=device, generator=torch.Generator(
        device=device).manual_seed(19)) * 3.0 + 1.0
    hold_moments(big, f"stratum moments {BIG_MOMENTS}")
    big_ms = time_ms(lambda: mops.moments_cuda(big))
    big_lib = time_ms(lambda: torch.var_mean(big, dim=1, correction=0))
    big_bound = (big.numel() + 3 * big.shape[0]) * 4 / HBM_BYTES_PER_S * 1e3
    for shape, ms, lib_ms, bound in ((tuple(vals.shape), mom["ms"], mom["library_ms"],
                                      mom["bound_ms"]),
                                     (BIG_MOMENTS, big_ms, big_lib, big_bound)):
        n_bytes = (shape[0] * shape[1] + 3 * shape[0]) * 4
        print(f"stratum moments {shape}: kernel {ms:.4f} ms ({n_bytes / ms / 1e6:.1f} "
              f"GB/s), torch.var_mean {lib_ms:.4f} ms, HBM bound {bound:.4f} ms "
              f"(kernel at {100 * bound / ms:.1f}% of it); on {card}")
    print(f"stratum moments {tuple(vals.shape)}: plain {mom['plain_ms']:.3f} ms")
    del big
    # the path: eval_strata(use_kernel=True) against the plain reduction
    mops.reset_kernel_launch_count()
    m_k, v_k = stratified.eval_strata(normal_fn, table.boxes, slots, 0, NORMAL_N_PER,
                                      key, use_kernel=True)
    torch.cuda.synchronize()
    mom["launches"] = mops.kernel_launch_count()
    m_p, v_p = stratified.eval_strata(normal_fn, table.boxes, slots, 0, NORMAL_N_PER, key)
    d_mean = float((m_k - m_p).abs().max())
    # the plain path's variance is E[f^2] - E[f]^2 in f32, which loses about
    # 2^-23 E[f^2] to cancellation; the kernel's is two-pass
    d_var = float(((v_k - v_p).abs()
                   / (1e-3 * v_p + 1e-6 * (v_p + m_p * m_p))).max())
    print(f"eval_strata(use_kernel=True) on {n0} strata x {NORMAL_N_PER}: "
          f"{mom['launches']} stratum_moments launch; vs the plain path: mean "
          f"max|diff| {d_mean:.3g} (atol 1e-5), variance |diff| at most "
          f"{d_var:.3g} of 1e-3 var + 1e-6 E[f^2]")
    check(mom["launches"] == 1, "eval_strata(use_kernel=True) launched no kernel")
    check(d_mean <= 1e-5 and d_var <= 1.0, "eval_strata's kernel path disagrees")
    mom["max_abs_err"] = mom_err
    del vals
    t0 = time.perf_counter()
    nres = ZMCNormal(normal_fn, np.tile([[0.0, 1.0]], (NORMAL_DIM, 1)), seed=0,
                     device="cuda").evaluate(num_trials=NORMAL_TRIALS)
    torch.cuda.synchronize()
    n_wall = time.perf_counter() - t0
    n_dev = abs(nres.integral - float(gpeak_exact[0]))
    print(f"ZMCNormal on {gpeak.name} (dim {NORMAL_DIM}, splits {NORMAL_SPLITS}, "
          f"n_per_stratum {NORMAL_N_PER}, depth 8, k_split 32): {nres.integral:.7f} "
          f"vs exact {float(gpeak_exact[0]):.7f}, |diff| {n_dev:.3g} = "
          f"{n_dev / max(nres.trial_std, 1e-30):.2f} trial stds (trial std "
          f"{nres.trial_std:.3g}, in-run stderr {nres.stderr:.3g}); "
          f"{n_wall / NORMAL_TRIALS:.3f} s per trial")
    check(n_dev <= 4 * nres.trial_std, "ZMCNormal is off its exact value")

    # -- 20. the multi-device path: a mesh of one NCCL rank, then four gloo ranks
    import tempfile

    import torch.distributed as dist
    from repro_torch.distributed import collectives
    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_mesh_for
    t20 = time.perf_counter()

    def est_digest(means, stderrs) -> str:
        return hashlib.sha256(np.ascontiguousarray(means).tobytes()
                              + np.ascontiguousarray(stderrs).tobytes()).hexdigest()

    # (a) world size 1 under NCCL, a (1, 1) mesh: the single-device bits
    with tempfile.TemporaryDirectory() as rv:
        dist.init_process_group("nccl", init_method=f"file://{rv}/rendezvous",
                                rank=0, world_size=1)
        try:
            mesh11 = make_mesh_for(device="cuda")
            for sampler, (m_ref, s_ref) in (("mc", main_est),
                                            ("sobol", (sres.means, sres.stderrs))):
                z = ZMCMultiFunctions(spec, n_samples=N_MAIN, seed=0, use_kernel=True,
                                      sampler=sampler, mesh=mesh11)
                template.reset_kernel_launch_count()
                t0 = time.perf_counter()
                r1 = z.evaluate(num_trials=TRIALS)
                torch.cuda.synchronize()
                w1 = (time.perf_counter() - t0) / TRIALS
                n1 = template.kernel_launch_count()
                same = est_digest(r1.means, r1.stderrs) == est_digest(m_ref, s_ref)
                print(f"mesh (1, 1), NCCL, {sampler}: evaluate(num_trials={TRIALS}) at "
                      f"N={N_MAIN}: {n1} kernel launches, {w1:.4f} s per trial (wall); "
                      f"means and stderrs sha256 {'equal' if same else 'DIFFER'} to "
                      f"the single-device run's (step {6 if sampler == 'mc' else 14})")
                check(n1 == plan.n_launches * TRIALS, f"mesh (1, 1) {sampler}: {n1} launches")
                check(same, f"mesh (1, 1) {sampler}: not the single-device bits")
                if sampler == "mc":
                    # steady state beside one device, in turns: one, mesh,
                    # mesh, one; 3 trials each
                    ws1_steady = {"one": [], "mesh": []}
                    for side, zz in (("one", zmc), ("mesh", z), ("mesh", z), ("one", zmc)):
                        t0 = time.perf_counter()
                        zz.evaluate(num_trials=3)
                        torch.cuda.synchronize()
                        ws1_steady[side].append((time.perf_counter() - t0) / 3)
            outs = [launch_bucket(template.fused_mc_cuda, b, N_MAIN, key)[0]
                    for b in plan.buckets]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                for o in outs:
                    collectives.psum_gather_rows(o, mesh11, ("data",), "model")
            torch.cuda.synchronize()
            ws1_coll = (time.perf_counter() - t0) * 1e3 / 20
        finally:
            dist.destroy_process_group()
    one_s, mesh_s = (sum(ws1_steady[k]) / 2 for k in ("one", "mesh"))
    print(f"mesh (1, 1), NCCL: steady state {1e3 * mesh_s:.3f} ms per trial against "
          f"{1e3 * one_s:.3f} on one device, in turns (one, mesh, mesh, one; 3 trials "
          f"each: one {', '.join(f'{1e3 * v:.3f}' for v in ws1_steady['one'])}, mesh "
          f"{', '.join(f'{1e3 * v:.3f}' for v in ws1_steady['mesh'])}): "
          f"{1e3 * (mesh_s - one_s):+.3f} ms per trial; the three gathers of one trial "
          f"alone {ws1_coll:.3f} ms; on {card}")

    # (b) four gloo ranks sharing this card (not scaling: one card's time is
    # split among them)
    t0 = time.perf_counter()
    ranks = multihost.spawn(mesh_rank, MESH_RANKS, device="cuda", backend="gloo",
                            timeout=600)
    print(f"{MESH_RANKS} gloo ranks on one card: {time.perf_counter() - t0:.1f} s "
          f"(process start, mesh setup and every check)")
    n_fam = len(spec.families)
    for rk in ranks:
        check(rk["fn_only_equal"] == {"mc": n_fam, "sobol": n_fam},
              f"rank {rk['rank']}: mesh (1, {MESH_RANKS}): per-function sums differ "
              f"from the single launch: {rk['fn_only_equal']}")
    print(f"mesh (1, {MESH_RANKS}), functions only: every family's sums sha256-equal to "
          f"the single-device launch on all {MESH_RANKS} ranks, MC and Sobol, N={N_MAIN}")
    for shape in ((MESH_RANKS, 1), (2, 2)):
        for sampler, (m_ref, s_ref) in (("mc", main_est), ("sobol", (sres.means, sres.stderrs))):
            got = [rk[(shape, sampler)] for rk in ranks]
            d_mean = max(float(np.max(np.abs(g["means"] - m_ref[0]) / s_ref[0])) for g in got)
            d_se = max(float(np.max(np.abs(g["stderrs"] - s_ref[0]) / s_ref[0])) for g in got)
            print(f"mesh {shape} {sampler}: raw sums at N={N_ODD} within "
                  f"{MESH_TOL[sampler]} of one device: {all(g['sums_ok'] for g in got)} "
                  f"(max|d s1| {max(g['max_abs'] for g in got):.4g}), n exact: "
                  f"{all(g['n_exact'] for g in got)}; estimates at N={N_MAIN} vs step "
                  f"{6 if sampler == 'mc' else 14}'s trial 0: max |d mean| {d_mean:.3g}, "
                  f"|d stderr| {d_se:.3g} standard errors (limit {EST_TOL})")
            check(all(g["sums_ok"] and g["n_exact"] for g in got),
                  f"mesh {shape} {sampler}: sums or n off")
            check(d_mean <= EST_TOL and d_se <= EST_TOL,
                  f"mesh {shape} {sampler}: estimates off the single device's")
            if shape == (2, 2):
                digests = {g["digest"] for g in got} | {g["repeat"] for g in got}
                print(f"mesh (2, 2) {sampler}: {len(digests)} distinct sha256 over "
                      f"{MESH_RANKS} ranks x 2 repeats")
                check(len(digests) == 1, f"mesh (2, 2) {sampler}: ranks or repeats differ")
    mesh_counts = ranks[0][((2, 2), "mc")]["counts"]
    print(f"mesh (2, 2) main path (evaluate at N={N_MAIN}, one trial), rank 0: kernel "
          f"launches by variant {mesh_counts}")
    for rk in ranks:
        check(rk[((2, 2), "mc")]["counts"]["fused_mc"] == plan.n_launches,
              f"rank {rk['rank']}: the (2, 2) evaluate did not launch fused_mc per bucket")
    check(all(rk["rounds_same"] == ROUNDS for rk in ranks),
          "a sharded R-round launch differs from its single-round launches")
    print(f"mesh (2, 2): an R={ROUNDS} sharded rounds launch sha256-equal to {ROUNDS} "
          f"single-round sharded launches on every rank")
    full_m = np.concatenate([r.means for r in full])
    full_s = np.concatenate([r.stderrs for r in full])
    for rk in ranks:
        sv = rk["service"]
        d_mean = float(np.max(np.abs(sv["means"] - full_m) / full_s))
        d_se = float(np.max(np.abs(sv["stderrs"] - full_s) / full_s))
        check(d_mean <= EST_TOL and d_se <= EST_TOL and sv["fallback"] == 0
              and sv["launches"] <= plan.n_launches * sv["waves"],
              f"rank {rk['rank']}: service config 2 on (2, 2) off: {d_mean}, {d_se}, {sv}")
    sv = ranks[0]["service"]
    print(f"service config 2 on (2, 2): {sv['waves']} waves, {sv['launches']} launches "
          f"per rank, {sv['fallback']} fallback rounds; estimates within {EST_TOL} "
          f"standard errors of step 12's on every rank")
    for rk in ranks:
        nm = rk["normal"]
        check(abs(nm["integral"] - nres.integral) <= 4 * nres.trial_std
              and nm["moments_launches"] > 0,
              f"rank {rk['rank']}: ZMCNormal on (2, 2) off: {nm}")
    nm = ranks[0]["normal"]
    print(f"ZMCNormal dim {NORMAL_DIM} on (2, 2) (samples over 4 ranks, moments kernel "
          f"per rank, {nm['moments_launches']} launches on rank 0): {nm['integral']:.7f} "
          f"vs step 19's {nres.integral:.7f} (4 trial stds: {4 * nres.trial_std:.3g}); "
          f"{nm['s_per_trial']:.3f} s per trial")
    for rk in ranks:
        c = rk["compressed"]
        check(c["err"] <= c["bound"] and c["on_card"],
              f"rank {rk['rank']}: compressed_psum off its bound: {c}")
    print(f"compressed_psum over data (2 shards): max|err| "
          f"{max(rk['compressed']['err'] for rk in ranks):.3g} within its int8 bound "
          f"{ranks[0]['compressed']['bound']:.3g}")
    for rk in ranks:
        sh = rk["shard"]
        print(f"rank {rk['rank']}: its shard of one Fig.-1 trial ({sh['n_local']} samples, "
              f"{sh['values']:.4g} values): kernel {sh['ms']:.3f} ms (the ranks taking "
              f"turns on the card), collectives {sh['collectives_ms']:.3f} ms per trial "
              f"(3 gathers, gloo through the host, the ranks together); max|kernel - "
              f"plain| {sh['max_abs_err']:.4g} at N={N_CHECK}")
    sh = ranks[0]["shard"]
    shard_bound = max(op_bound_ms(sh["draws"], sh["values"], n_sm, clock_hz).values())
    print(f"four ranks share one card: these times split one card's work, they are not "
          f"scaling; rank 0's shard kernel {sh['ms']:.3f} ms against its bound "
          f"{shard_bound:.3f} ms, plain {sh['plain_ms']:.1f} ms; step 20 "
          f"{time.perf_counter() - t20:.1f} s; on {card}")
    sharded = dict(launches=mesh_counts["fused_mc"], max_abs_err=max(
        rk["shard"]["max_abs_err"] for rk in ranks), ms=sh["ms"],
        plain_ms=sh["plain_ms"], bound_ms=shard_bound)

    # -- 21. a state dir on the (2, 2) mesh, resumed; the invariant checker -----
    from repro_torch.analysis import __main__ as analysis_cli
    from repro_torch.analysis import contracts as analysis_contracts
    from repro_torch.analysis.streams import audit_state_dir
    from repro_torch.kernels import registry
    t21 = time.perf_counter()
    sv20 = ranks[0]["service"]
    whole = est_digest(sv20["means"], sv20["stderrs"])
    mesh_state = tempfile.mkdtemp(prefix="zmc_mesh_state_")
    lease_path = os.path.join(mesh_state, "lease.json")
    # (a) configuration 2 with a state dir, abandoned after its first wave by
    # four ranks, resumed by four new ones, then replayed warm
    # (no device: spawn's default is the card)
    first = multihost.spawn(state_rank, MESH_RANKS, mesh_state, 1, backend="gloo",
                            timeout=600)
    with open(lease_path, encoding="utf-8") as f:
        left = json.load(f)["pid"]
    # the journal as the abandoned ranks left it, audited in (b)
    shutil.copytree(mesh_state, f"{mesh_state}_abandoned")
    second = multihost.spawn(state_rank, MESH_RANKS, mesh_state, None, device="cuda",
                             backend="gloo", timeout=600)
    ab, rs, rp = first[0]["abandoned"], second[0]["resumed"], second[0]["replay"]
    for group, run in ((first, "abandoned"), (second, "resumed"), (second, "replay")):
        for rk in group:
            got = rk[run]
            check(got["kernel_launches"] == got["dispatches"] and got["fallback"] == 0,
                  f"rank {rk['rank']}, {run}: {got['dispatches']} dispatches, "
                  f"{got['kernel_launches']} CUDA kernel launches, {got['fallback']} "
                  "fallback rounds")
            check(rk["lease_pids"] == {group[0]["pid"]},
                  f"rank {rk['rank']}, {run}: lease.json named pids {rk['lease_pids']}, "
                  f"rank 0 is {group[0]['pid']}")
            if run != "abandoned":
                check(est_digest(got["means"], got["stderrs"]) == whole,
                      f"rank {rk['rank']}, {run}: served estimates differ from step 20's")
            if run == "resumed":
                check(got["counts"]["fused_mc_rounds"] > 0,
                      f"rank {rk['rank']}: the resumed run never launched fused_mc_rounds")
    check(left == first[0]["pid"], f"the abandoned dir's lease names pid {left}")
    check(not os.path.exists(lease_path), "the resumed ranks' close() left the lease")
    check(len(ab["wave_s"]) == 1 and len(rs["wave_s"]) == sv20["waves"] - 1
          and ab["kernel_launches"] + rs["kernel_launches"] == sv20["launches"],
          f"abandoned {ab['kernel_launches']} + resumed {rs['kernel_launches']} launches "
          f"over {len(ab['wave_s'])} + {len(rs['wave_s'])} waves, step 20 "
          f"{sv20['launches']} over {sv20['waves']}")
    check(rp["dispatches"] == 0 and rp["hits"] == len(spec.families),
          f"warm replay: {rp['dispatches']} launches, {rp['hits']} pure hits")
    print(f"service config 2 on (2, 2) with a state dir (rank 0 owns it): abandoned "
          f"after wave 1 ({ab['kernel_launches']} launches), resumed by 4 new ranks "
          f"({rs['kernel_launches']} launches over {len(rs['wave_s'])} wave(s), "
          f"{rs['counts']}), served estimates sha256-equal to step 20's run on every "
          f"rank ({whole[:16]}); warm replay {rp['dispatches']} launches, "
          f"{rp['hits']} pure hits; lease.json only ever named rank 0's pid")
    def ms(xs):
        return [round(1e3 * x, 3) for x in xs]

    turns = second[0]["turns"]
    mean_wave = {disk: float(np.mean([w for d, ws, _, _ in turns if d == disk for w in ws]))
                 for disk in (False, True)}
    print("mesh (2, 2) config 2, warm ranks in turns (none, dir, dir, none; rank 0): "
          + "; ".join(f"{'state dir' if d else 'no state dir'} waves {ms(ws)} ms"
                      + (f" (store operations {ms(st)} ms)" if d else "")
                      + f", submit {1e3 * sub:.1f} ms" for d, ws, st, sub in turns)
          + f"; mean wave {1e3 * mean_wave[True]:.3f} ms with the state dir against "
          f"{1e3 * mean_wave[False]:.3f} without: "
          f"{1e3 * (mean_wave[True] - mean_wave[False]):+.3f} ms per wave; on {card}")
    print(f"mesh (2, 2) config 2 wall per wave (ms, rank 0): step 20 without a state "
          f"dir {ms(sv20['wave_s'])}; with one: abandoned run's wave 1 {ms(ab['wave_s'])}, "
          f"resumed run's wave 2 {ms(rs['wave_s'])}; on {card}")
    for label, group, run in (("abandoned wave 1", first, "abandoned"),
                              ("resumed wave 2", second, "resumed")):
        print(f"  {label}: per rank, time in the store's operations (rank 0's write, "
              f"then the broadcast) {[ms(rk[run]['store_s']) for rk in group]} ms; rank "
              f"0's deposit span {ms(group[0][run]['deposit_s'])} ms, of which "
              f"wal_commit {ms(group[0][run]['wal_s'])} ms")
    print(f"  resume (rank 0): open and recover {1e3 * rs['open_s']:.3f} ms, submit "
          f"{1e3 * rs['submit_s']:.3f} ms, its wave {ms(rs['wave_s'])} ms, close with "
          f"the snapshot {1e3 * rs['close_s']:.3f} ms; the state dir's file system: "
          f"fsync of a 100 KB append {ms(second[0]['fsync_s'])} ms; one outcome "
          f"broadcast alone {ms([rk['broadcast_s'] for rk in second])} ms per rank; "
          f"the abandoned run "
          f"opened in {1e3 * ab['open_s']:.3f} ms and submitted in "
          f"{1e3 * ab['submit_s']:.3f} ms")
    # (b) every state dir this script wrote, through the port's auditor
    for label, path in (("step 11", state),
                        ("step 18 uninterrupted", os.path.join(work, "uninterrupted")),
                        ("step 18 abandoned and resumed", os.path.join(work, "interrupted")),
                        ("step 21 abandoned after wave 1", f"{mesh_state}_abandoned"),
                        ("step 21", mesh_state),
                        ("step 21 warm turn 1", f"{mesh_state}_warm1"),
                        ("step 21 warm turn 2", f"{mesh_state}_warm2")):
        t0 = time.perf_counter()
        report = audit_state_dir(path)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"audit ({label}): {report.summary()}; {ms:.3f} ms")
        check(report.ok and report.streams > 0, f"audit ({label}): {report.violations}")
    # (c) the lint and every registered form's contracts
    t0 = time.perf_counter()
    rc = analysis_cli.main([])
    secs = time.perf_counter() - t0
    forms = registry.forms()
    combos = sum(len(analysis_contracts._combos(f)) for f in forms)
    print(f"python -m repro_torch.analysis: exit {rc}; lint of src/repro_torch and "
          f"{len(forms)} forms' contracts over {combos} capability combinations in "
          f"{secs:.3f} s")
    check(rc == 0, "the invariant checker found violations")
    for path in (state, work, mesh_state, f"{mesh_state}_abandoned",
                 f"{mesh_state}_warm1", f"{mesh_state}_warm2"):
        shutil.rmtree(path, ignore_errors=True)
    print(f"step 21 {time.perf_counter() - t21:.1f} s; on {card}")

    entry = dict(route="cuda", source="src/repro_torch/kernels/csrc/fused_mc.cu",
                 bound_by="operations", library_ms=None)
    print(json.dumps({"kernels": [
        dict(entry, name="fused_mc", replaces="src/repro/kernels/template.py:425",
             launches=main_counts["fused_mc"], max_abs_err=max_err,
             ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms),
        dict(entry, name="fused_mc_rounds",
             replaces="src/repro/kernels/template.py:457",
             launches=service_counts["fused_mc_rounds"], max_abs_err=rounds_err,
             ms=wave_ms, plain_ms=wave_plain_ms, bound_ms=wave_bound),
        dict(entry, name="fused_mc_compactified",
             replaces="src/repro/kernels/template.py:189",
             launches=service_counts["fused_mc_compactified"],
             max_abs_err=compact_err, ms=compact_ms, plain_ms=compact_plain_ms,
             bound_ms=compact_bound),
        dict(entry, name="fused_mc_sobol_compactified",
             replaces="src/repro/kernels/template.py:189", **compact_sobol),
        dict(entry, name="fused_mc_sobol",
             replaces="src/repro/kernels/template.py:172",
             launches=sobol_counts["fused_mc_sobol"], max_abs_err=sobol_err,
             ms=sobol_ms, plain_ms=sobol_plain_ms, bound_ms=sobol_bound),
        dict(entry, name="fused_mc_swept",
             replaces="src/repro/kernels/template.py:231", **swept["mc"]),
        dict(entry, name="fused_mc_sobol_swept",
             replaces="src/repro/kernels/template.py:231", **swept["sobol"]),
        *(dict(entry, name=name, replaces="src/repro/kernels/template.py:318",
               **{k: v for k, v in adapted[s].items() if k != "res"})
          for name, s in (("fused_mc_adapted", "mc"), ("fused_mc_sobol_adapted", "sobol"))),
        dict(entry, name="fused_mc_sharded",
             replaces="src/repro/kernels/template.py:425", **sharded),
        dict(name="stratum_moments", route="cuda",
             source="src/repro_torch/kernels/csrc/moments.cu",
             replaces="src/repro/kernels/moments/kernel.py:43", bound_by="bytes", **mom),
    ]}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
