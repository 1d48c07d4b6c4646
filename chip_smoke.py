#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
with nvcc, checks them against their plain PyTorch versions on the card,
and drives the port's main path — ``ZMCMultiFunctions(spec,
use_kernel=True).evaluate()`` — on the paper's Fig.-1 workload (1200
integrands, five forms, dims 2-4) at 10^6 samples x 10 trials:

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
   mix nvcc emitted for pass 1's inner loops (``cuobjdump -sass``);
8. times steady-state trials and profiles one (device busy and idle
   share, host operations by time), and prints the ``{"kernels": [...]}``
   line.

Any failed check exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script fails and prints no result.
"""

from __future__ import annotations

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


def launch_bucket(fn, bucket, n_samples, key):
    import math
    from repro_torch.kernels import template
    return fn(template.pack_scalars(key, 0, n_samples), bucket.fn_ids,
              bucket.packed, bucket.lo, bucket.hi, bucket.block_forms,
              dim=bucket.dim,
              n_sample_blocks=max(1, math.ceil(n_samples / template.S_BLK)))


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


def op_bound_ms(draws: float, values: float, n_sm: int, clock_hz: float) -> dict:
    """The least time the card needs for one trial's operations, per
    resource (ms).  Integer adds go to whichever of the ALU and FMA pipes
    leaves the busier one least loaded."""
    alu_only, adds = draws * TF_ALU_ONLY, draws * TF_ADDS
    fp, conv = draws * FP32_PER_DRAW + values * FP32_PER_VALUE, draws * CONV_PER_DRAW

    def pipes(a):                       # a: adds issued on the ALU pipe
        return max((alu_only + a) / ALU_PER_CLK, (adds - a) / IMAD_PER_CLK,
                   (adds - a + fp) / FMA_PER_CLK)

    clocks = {
        "ALU and FMA pipes": min(pipes(adds * i / 100) for i in range(101)),
        "issue": (alu_only + adds + fp + conv) / ISSUE_PER_CLK,
        "conversion": conv / CONV_PER_CLK,
    }
    return {k: v / (n_sm * clock_hz) * 1e3 for k, v in clocks.items()}


ALU_OPS = ("IADD3", "LOP3", "SHF", "PRMT", "LEA", "ISETP", "FSETP", "SEL",
           "FSEL", "IMNMX", "FMNMX", "IABS", "MOV", "PLOP3")
FMA_OPS = ("IMAD", "FFMA", "FADD", "FMUL")


def sass_loops(lib_path) -> list[dict] | None:
    """Instruction mix of pass 1's innermost Threefry loops, read from
    ``cuobjdump -sass`` of the built library: per loop its instructions,
    its draws (one u32 -> f32 conversion each) and opcode counts.  None
    when the tool is missing or its listing cannot be read: this is a
    report of what nvcc emitted, not a check."""
    import collections
    import re
    import shutil
    from repro_torch.kernels import build
    tool = (shutil.which("cuobjdump")
            or os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump"))
    try:
        out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                             text=True, timeout=120)
    except OSError:
        return None
    if out.returncode != 0:
        return None
    body, inside = [], False
    for line in out.stdout.splitlines():
        if "Function :" in line:
            inside = "fused_mc_pass1" in line
        elif inside:
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);",
                          line)
            if m:
                body.append((int(m.group(1), 16), m.group(2), m.group(3)))
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
        rotates = sum(n for op, n in ops.items() if op.startswith("SHF") and ".W" in op)
        draws = sum(n for op, n in ops.items() if op.startswith("I2F"))
        if rotates >= 10 and draws:
            found.append({
                "range": f"0x{a:x}-0x{b:x}", "draws": draws, "rotates": rotates,
                "instr": sum(ops.values()),
                "alu": sum(n for op, n in ops.items() if op.split(".")[0] in ALU_OPS),
                "fma": sum(n for op, n in ops.items() if op.split(".")[0] in FMA_OPS),
                "ops": ops})
    return found or None


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
    if loops is None:
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

    print(json.dumps({"kernels": [{
        "name": "fused_mc",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_mc.cu",
        "replaces": "src/repro/kernels/template.py:425",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations",
        "library_ms": None,
    }]}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
