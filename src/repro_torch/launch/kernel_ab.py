"""Two versions of the fused kernel's CUDA source, built and timed on one
card.

``python -m repro_torch.launch.kernel_ab --other DIR`` (from the repo
root, ``PYTHONPATH=src``) takes ``DIR``, the root of another checkout of
this repo (for example the parent commit unpacked with ``git archive``)
whose fused kernel library exports the same C interface.  It builds both
libraries at once, each with its own checkout's ``kernels/build.py`` and
``-Xptxas -v``, and prints each build's seconds and the registers and
spills of every pass-1 instantiation.  Then it launches each variant
through each library in turn (this, other, other, this, ...; CUDA
events) and prints its median ms per library:
- ``mc``: one MC trial of ``chip_smoke.fig1_spec`` at N = 10^6 (3 launches);
- ``sobol``: the same trial with Sobol draws;
- ``compactified``: ``chip_smoke.compact_spec``, compactified as
  ``evaluate`` does, at N = 10^6 (3 launches);
- ``sweep_mc``, ``sweep_sobol``: one wave of service configuration 3, the
  4-d harmonic template swept over a 32 x 32 (a, b) grid, rounds of
  65536 samples, R = 8 (one launch).
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


def _pass1_lines(log: str) -> list[str]:
    """ptxas's entry, register and spill lines of the pass-1 functions."""
    out, in_pass1 = [], False
    for line in log.splitlines():
        if "entry function" in line:
            in_pass1 = "fused_mc_pass1" in line
        if in_pass1 and ("entry function" in line or "registers" in line
                         or "spill" in line):
            out.append(line.strip())
    return out


def build_both(other_root: Path):
    """Build this tree's library and ``other_root``'s together, each by its
    own ``kernels/build.py``; returns (other's ctypes library,
    {"this"|"other": (seconds, ptxas lines)})."""
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
    return lib, {"this": (this["seconds"], _pass1_lines(this["log"])),
                 "other": (other[LIB]["seconds"], _pass1_lines(other[LIB]["log"]))}


def variants(device):
    """name -> a function that launches the variant once and returns its
    outputs."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    key = rng.fold_key(0, 0)
    spec, _ = chip_smoke.fig1_spec(device)
    cspec, _ = chip_smoke.compact_spec(device)
    plans = {"mc": multi.plan_spec(spec), "sobol": multi.plan_spec(spec, sampler="sobol"),
             "compactified": multi.plan_spec(MultiFunctionSpec.from_families(
                 [f.compactified() for f in cspec.families]))}
    a = np.linspace(*chip_smoke.SWEEP_A).astype(np.float32)
    b = np.linspace(*chip_smoke.SWEEP_B).astype(np.float32)
    aa, bb = np.meshgrid(a, b, indexing="ij")
    sweep = MultiFunctionSpec.from_families(
        [harmonic_family(1, 4).swept_over({"a": aa.ravel(), "b": bb.ravel()})]).to(device)

    def trial(plan):
        return lambda: [chip_smoke.launch_bucket(
            template.fused_mc_cuda, bk, chip_smoke.N_MAIN, key, sampler=plan.sampler,
            block_tcols=bk.block_tcols, block_sweep=bk.block_sweep,
            block_meta=bk.block_meta, dirvecs=bk.dirvecs) for bk in plan.buckets]

    def wave(plan):
        return lambda: multi.launch_plan_rounds(
            plan, chip_smoke.FULL_ROUND, chip_smoke.FULL_R, key,
            start_rounds={0: 0})[1]

    out = {name: trial(plan) for name, plan in plans.items()}
    for sampler in ("mc", "sobol"):
        out[f"sweep_{sampler}"] = wave(multi.plan_spec(sweep, sampler=sampler))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_ab needs a CUDA device")
    device = torch.device("cuda", 0)
    other_lib, builds = build_both(args.other.resolve())
    for name, (secs, lines) in builds.items():
        print(f"build {name}: {secs:.1f} s, {sum('entry' in x for x in lines)} "
              f"pass-1 instantiations")
        for line in lines:
            print(f"  {name}: {line}")
    libs = {"this": build.load(LIB), "other": other_lib}
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ok = True
    for vname, launch in variants(device).items():
        times = {"this": [], "other": []}
        digests = {}
        for who in ["this", "other", "other", "this"] * PAIRS:
            build._LOADED[LIB] = libs[who]
            outs = launch()
            torch.cuda.synchronize()
            if who not in digests:
                digests[who] = hashlib.sha256(b"".join(
                    o.cpu().numpy().tobytes() for o in outs)).hexdigest()
            ev0.record()
            for _ in range(REPS):
                launch()
            ev1.record()
            torch.cuda.synchronize()
            times[who].append(ev0.elapsed_time(ev1) / REPS)
        same = digests["this"] == digests["other"]
        ok &= same
        print(f"{vname}: this {statistics.median(times['this']):.3f} ms, other "
              f"{statistics.median(times['other']):.3f} ms (medians of "
              f"{len(times['this'])}; this {', '.join(f'{t:.3f}' for t in times['this'])}; "
              f"other {', '.join(f'{t:.3f}' for t in times['other'])}); outputs "
              f"bit-equal: {same}")
    build._LOADED[LIB] = libs["this"]
    if not ok:
        sys.exit("the two libraries' outputs differ")


if __name__ == "__main__":
    main()
