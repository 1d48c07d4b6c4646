"""Integration launcher: the paper's workload as a job (PyTorch port of
``repro.launch.integrate``).

``python -m repro_torch.launch.integrate --device cuda --use-kernel``
evaluates the Fig.-1 harmonic family with checkpointed rounds, the step
watchdog and restart-on-failure, and prints the agreement with the
analytic values.  ``--device cpu`` runs the plain PyTorch path.

``--mesh`` shards over every rank: functions over ``model`` (2 shards
when the world is even and larger than 1), samples over ``data``.  Under
torchrun (or ``REPRO_COORD``/``REPRO_NUM_PROCS``/``REPRO_PROC_ID``) each
process is a rank; otherwise the launcher starts ``--ranks`` of them
itself.  NCCL on the card needs a card per rank; ranks sharing a card
take ``--backend gloo``.  Rank 0 prints.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch.distributed as dist

from repro_torch.core.integrand import (MultiFunctionSpec, harmonic_analytic,
                                        harmonic_family)
from repro_torch.core.multifunctions import ZMCMultiFunctions
from repro_torch.distributed.fault_tolerance import (StepWatchdog,
                                                     run_with_restarts)
from repro_torch.launch import multihost
from repro_torch.launch.mesh import launcher_mesh, mesh_info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-functions", type=int, default=100)
    ap.add_argument("--dim", type=int, default=4)
    ap.add_argument("--samples", type=int, default=10**6)
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--use-kernel", action="store_true",
                    help="fused kernel (CUDA on the card, plain on the CPU)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    multihost.add_mesh_args(ap)
    args = ap.parse_args(argv)

    if args.mesh and not multihost.initialize_if_needed(
            verbose=False, device=args.device, backend=args.backend):
        return multihost.spawn_launcher(main, args,
                                        sys.argv[1:] if argv is None else argv)
    mesh = launcher_mesh(args.device) if args.mesh else None
    spec = MultiFunctionSpec.from_families(
        [harmonic_family(args.n_functions, args.dim)])
    zmc = ZMCMultiFunctions(spec, n_samples=args.samples, seed=args.seed,
                            use_kernel=args.use_kernel, device=args.device,
                            mesh=mesh)
    watchdog = StepWatchdog()

    def body(attempt: int):
        means, stds = [], []
        for t in range(args.trials):
            with watchdog:
                r = zmc.evaluate_resumable(rounds=args.rounds,
                                           checkpoint_dir=args.ckpt_dir,
                                           trial=t)
            means.append(r.means[0])
            stds.append(r.stderrs[0])
        return np.stack(means), np.stack(stds)

    t0 = time.time()
    means, stds = run_with_restarts(body, max_restarts=2)
    dt = time.time() - t0

    exact = harmonic_analytic(args.n_functions, args.dim)
    fbar = means.mean(0)
    dfn = means.std(0, ddof=1) if args.trials > 1 else stds.mean(0)
    within = np.abs(fbar - exact) <= 2 * np.maximum(dfn, 1e-12)
    if mesh is not None and dist.get_rank() != 0:
        return int(within.sum())
    where = f"{zmc.device}" if mesh is None else f"mesh {mesh_info(mesh)['shape']}"
    print(f"{args.n_functions} integrands x {args.samples:.0e} samples "
          f"x {args.trials} trials on {where} in {dt:.1f}s "
          f"({dt / max(args.trials, 1):.1f}s per trial)")
    print(f"|F_bar - exact| <= 2*dF for {within.sum()}/{len(within)} "
          f"integrands; stragglers: {watchdog.straggler_count}")
    worst = np.argmax(np.abs(fbar - exact) / np.maximum(dfn, 1e-12))
    print(f"worst pull at n={worst + 1}: est {fbar[worst]:+.5f} "
          f"exact {exact[worst]:+.5f} (dF {dfn[worst]:.2e})")
    return int(within.sum())


if __name__ == "__main__":
    main()
