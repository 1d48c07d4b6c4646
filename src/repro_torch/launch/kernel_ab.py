"""Two versions of the fused kernel's CUDA source, built and timed on one
card.

``python -m repro_torch.launch.kernel_ab --other DIR`` (from the repo
root, ``PYTHONPATH=src``) takes ``DIR``, the root of another checkout of
this repo (for example the parent commit unpacked with ``git archive``)
whose fused kernel library exports the same C interface.  It builds both
libraries at once, each with its own checkout's ``kernels/build.py`` and
``-Xptxas -v``, and prints each build's seconds and, for every pass-1
instantiation, its registers, spill stores and the blocks of 256 threads
that its registers leave resident on one SM.  Then it launches each variant
through each library in turn (this, other, other, this, ...; CUDA
events) and prints its median ms per library:
- ``mc``: one MC trial of ``chip_smoke.fig1_spec`` at N = 10^6 (3 launches);
- ``sobol``: the same trial with Sobol draws;
- ``compactified``: ``chip_smoke.compact_spec``, compactified as
  ``evaluate`` does, at N = 10^6 (3 launches); ``compactified_sobol``:
  the same with Sobol draws;
- ``rounds``: one wave of service configuration 2 as ``chip_smoke.py``
  step 12 launches it, the Fig.-1 spec as requests of 2^20 samples in
  rounds of 65536: R = 8 rounds per launch from per-block window starts
  (the second wave's, round 8), through ``multi.launch_plan_rounds`` (3
  launches);
- ``sweep_mc``, ``sweep_sobol``: one wave of service configuration 3, the
  4-d harmonic template swept over a 32 x 32 (a, b) grid, rounds of
  65536 samples, R = 8 (one launch);
- ``adapted_mc``, ``adapted_sobol``: one trial of
  ``chip_smoke.adapted_spec`` (1024 peaked integrands with importance
  grids, 128 of them compactified too) at N = 10^6 (3 launches), per
  sampler; the grids are fitted once, in this checkout's Python, so both
  libraries launch the same rows;
- ``every_form_sobol``, ``every_form_mc``: each of the five forms through
  every loop of the kernel (:func:`every_form_spec`: finite,
  compactified, adapted and compactified-then-adapted families) at
  N = 2^20, per sampler three launches: the finite families alone, with
  the compactified ones and with all four kinds (the instantiations
  ``<0|1|2, true, true>`` for Sobol, ``<0, false, false>``,
  ``<1, false, true>`` and ``<2, false, true>`` for MC).
It fails unless both libraries' outputs agree bit for bit.  Needs one
card; builds into ``kernels/_build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import statistics
import sys
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import rng
from repro_torch.core.integrand import MultiFunctionSpec, harmonic_family
from repro_torch.kernels import build, template
from repro_torch.kernels.mc_eval import multi

ROOT = Path(__file__).resolve().parents[3]
LIB = "zmc_fused_mc"
PAIRS = 3          # (this, other, other, this) sequences per variant
REPS = 5           # launches per timing


def build_both(other_root: Path):
    """Build this tree's library and ``other_root``'s together, each by its
    own ``kernels/build.py``; returns (other's ctypes library,
    {"this"|"other": (seconds, ``build.pass1_resources`` of its log)})."""
    spec = importlib.util.spec_from_file_location(
        "other_build", other_root / "src/repro_torch/kernels/build.py")
    other_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other_build)
    other = {}
    worker = threading.Thread(
        target=lambda: other.update(other_build.build([LIB], verbose=True)))
    worker.start()
    this = build.build([LIB], verbose=True)[LIB]
    worker.join()
    if LIB not in other:
        raise RuntimeError(f"the build of {other_root} failed (see above)")
    lib = ctypes.CDLL(str(other[LIB]["path"]))
    build._declare(lib)
    return lib, {"this": (this["seconds"], build.pass1_resources(this["log"])),
                 "other": (other[LIB]["seconds"],
                           build.pass1_resources(other[LIB]["log"]))}


def every_form_spec(device, dim: int = 3, n: int = 32) -> MultiFunctionSpec:
    """Each form (harmonic, abs_sum, Gaussian, Genz oscillatory and corner
    peak, n functions at ``dim``) four times: on its finite box,
    compactified (axis 0 over R, axis 1 over [a, inf), axis 2 over
    (-inf, b]), and each of those two with an importance grid of 8 bins
    fitted from one pilot: every loop kind of the fused kernel, for
    holding two builds bit for bit (not an accuracy workload)."""
    import dataclasses
    from repro_torch.core import adaptive, genz
    from repro_torch.core.integrand import abs_sum_family, gaussian_family
    bases = [harmonic_family(n, dim), abs_sum_family(n, dim, np.linspace(0.5, 2, n)),
             gaussian_family(n, dim, lo=-2.0, hi=2.0), genz.oscillatory(n, dim)[0],
             genz.corner_peak(n, dim)[0]]
    fams = []
    for i, fam in enumerate(bases):
        fam = fam.to(device)
        dom = fam.domains.clone()
        dom[:, 0, 0], dom[:, 0, 1] = -float("inf"), float("inf")
        dom[:, 1, 1] = float("inf")
        dom[:, 2, 0] = -float("inf")
        comp = dataclasses.replace(fam, domains=dom, name=fam.name + ":inf").compactified()
        fams += [fam, comp]
        for j, g in enumerate((fam, comp)):
            edges = adaptive.initial_edges(g.domains, 8)
            weights = adaptive.pilot_weights(g, edges, rng.fold_key(77, 10 * i + j), 1024)
            fams.append(g.adapted(adaptive.refine_edges(edges, weights), epoch=1))
    return MultiFunctionSpec.from_families(fams)


def variants(device):
    """name -> a function that launches the variant once and returns its
    outputs."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    key = rng.fold_key(0, 0)
    spec, _ = chip_smoke.fig1_spec(device)
    cspec, _ = chip_smoke.compact_spec(device)
    cspec = MultiFunctionSpec.from_families([f.compactified() for f in cspec.families])
    plans = {"mc": multi.plan_spec(spec), "sobol": multi.plan_spec(spec, sampler="sobol"),
             "compactified": multi.plan_spec(cspec),
             "compactified_sobol": multi.plan_spec(cspec, sampler="sobol")}
    a = np.linspace(*chip_smoke.SWEEP_A).astype(np.float32)
    b = np.linspace(*chip_smoke.SWEEP_B).astype(np.float32)
    aa, bb = np.meshgrid(a, b, indexing="ij")
    sweep = MultiFunctionSpec.from_families(
        [harmonic_family(1, 4).swept_over({"a": aa.ravel(), "b": bb.ravel()})]).to(device)
    aspec = chip_smoke.adapted_spec(device)[0]
    every = every_form_spec(device)
    kinds = [MultiFunctionSpec.from_families([f for i, f in enumerate(every.families)
                                              if i % 4 in keep])
             for keep in ((0,), (0, 1), (0, 1, 2, 3))]

    def trial(plan):
        return trial_at(plan, chip_smoke.N_MAIN)

    def trial_at(plan, n_samples):
        return lambda: [chip_smoke.launch_bucket(
            template.fused_mc_cuda, bk, n_samples, key, sampler=plan.sampler,
            block_tcols=bk.block_tcols, block_sweep=bk.block_sweep,
            block_adapt=bk.block_adapt, block_meta=bk.block_meta,
            dirvecs=bk.dirvecs) for bk in plan.buckets]

    def wave(plan, start_round=0):
        starts = {sl.family_index: start_round for bk in plan.buckets for sl in bk.slices}
        return lambda: multi.launch_plan_rounds(
            plan, chip_smoke.FULL_ROUND, chip_smoke.FULL_R, key,
            start_rounds=starts)[1]

    out = {name: trial(plan) for name, plan in plans.items()}
    out["rounds"] = wave(plans["mc"], chip_smoke.FULL_R)
    for sampler in ("mc", "sobol"):
        out[f"sweep_{sampler}"] = wave(multi.plan_spec(sweep, sampler=sampler))
    for sampler in ("mc", "sobol"):
        out[f"adapted_{sampler}"] = trial(multi.plan_spec(aspec, sampler=sampler))
    for sampler in ("sobol", "mc"):
        every_plans = [multi.plan_spec(k, sampler=sampler) for k in kinds]
        out[f"every_form_{sampler}"] = (
            lambda ps=every_plans: [o for p in ps for o in trial_at(p, 1 << 20)()])
    return out


def describe_difference(this, other) -> str:
    """Where two launches' outputs differ: per output, the f32 words that
    differ, how many of them are NaN in both, and the largest difference
    where both are finite."""
    parts = []
    for i, (a, b) in enumerate(zip(this, other)):
        bad = a.view(np.int32) != b.view(np.int32)
        if not bad.any():
            continue
        both_nan = np.isnan(a) & np.isnan(b)
        fin = bad & np.isfinite(a) & np.isfinite(b)
        worst = float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0
        parts.append(f"output {i}: {int(bad.sum())} of {a.size} words differ, "
                     f"{int((bad & both_nan).sum())} of them NaN in both, max |diff| "
                     f"{worst:.6g} where both are finite")
    return "; ".join(parts)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_ab needs a CUDA device")
    device = torch.device("cuda", 0)
    other_lib, builds = build_both(args.other.resolve())
    for name, (secs, res) in builds.items():
        print(f"build {name}: {secs:.1f} s, {len(res)} pass-1 instantiations")
        for r in res:
            print(f"  {name}: fused_mc_pass1{r['name']}: {r['registers']} registers, "
                  f"{r['spill_stores']} bytes of spill stores, {r['blocks_per_sm']} "
                  f"resident blocks per SM")
    libs = {"this": build.load(LIB), "other": other_lib}
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ok = True
    for vname, launch in variants(device).items():
        times = {"this": [], "other": []}
        firsts = {}
        for who in ["this", "other", "other", "this"] * PAIRS:
            build._LOADED[LIB] = libs[who]
            outs = launch()
            torch.cuda.synchronize()
            if who not in firsts:
                firsts[who] = [o.cpu().numpy() for o in outs]
            ev0.record()
            for _ in range(REPS):
                launch()
            ev1.record()
            torch.cuda.synchronize()
            times[who].append(ev0.elapsed_time(ev1) / REPS)
        digests = {who: hashlib.sha256(b"".join(o.tobytes() for o in outs)).hexdigest()
                   for who, outs in firsts.items()}
        same = digests["this"] == digests["other"]
        ok &= same
        print(f"{vname}: this {statistics.median(times['this']):.3f} ms, other "
              f"{statistics.median(times['other']):.3f} ms (medians of "
              f"{len(times['this'])}; this {', '.join(f'{t:.3f}' for t in times['this'])}; "
              f"other {', '.join(f'{t:.3f}' for t in times['other'])}); outputs "
              f"bit-equal: {same}")
        if not same:
            print("  " + describe_difference(firsts["this"], firsts["other"]))
    build._LOADED[LIB] = libs["this"]
    if not ok:
        sys.exit("the two libraries' outputs differ")


if __name__ == "__main__":
    main()
