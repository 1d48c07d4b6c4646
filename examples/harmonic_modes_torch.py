"""Paper Fig. 1 end-to-end on the PyTorch port: harmonic-mode decomposition
with error band (``examples/harmonic_modes.py``'s counterpart on
``repro_torch``).

    PYTHONPATH=src python examples/harmonic_modes_torch.py [--full] [--use-kernel] [--device cpu]

Evaluates F_n = Int_{[0,1]^4} cos(k_n.x) + sin(k_n.x) dx for n = 1..100
over independent trials and prints an ASCII version of the paper's figure:
the +-dF band around F_bar with the analytic curve overlaid.  With
``--use-kernel`` the 100 integrands go through the fused CUDA kernel (its
plain PyTorch version on the CPU).  Runs on the card by default and raises
without one.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np

from repro_torch.core import (ZMCMultiFunctions, harmonic_analytic,
                              harmonic_family)


def main(device="cuda", full: bool = False, use_kernel: bool = False,
         n_samples: int | None = None, num_trials: int | None = None):
    """The figure at 10^5 samples x 6 trials, or 10^6 x 10 with ``full``
    (``n_samples`` / ``num_trials`` override either); returns ``(solver,
    result, 2-sigma coverage)``."""
    samples = n_samples or (10**6 if full else 10**5)
    trials = num_trials or (10 if full else 6)

    zmc = ZMCMultiFunctions([harmonic_family(100, 4)], n_samples=samples,
                            seed=0, use_kernel=use_kernel, device=device)
    r = zmc.evaluate(num_trials=trials)
    exact = harmonic_analytic(100, 4)
    fbar, dfn = r.trial_mean, np.maximum(r.trial_std, 1e-12)

    lo, hi = (fbar - dfn).min(), (fbar + dfn).max()
    width = 64
    print(f"F_n for n=1..100 ({samples:.0e} samples x {trials} trials); "
          f"band = [F-dF, F+dF], * = analytic")
    for i in range(0, 100, 2):
        a = int((fbar[i] - dfn[i] - lo) / (hi - lo) * (width - 1))
        b = int((fbar[i] + dfn[i] - lo) / (hi - lo) * (width - 1))
        e = int((exact[i] - lo) / (hi - lo) * (width - 1))
        row = [" "] * width
        for j in range(a, b + 1):
            row[j] = "-"
        row[max(0, min(width - 1, e))] = "*"
        print(f"n={i+1:3d} |{''.join(row)}|")

    pull = np.abs(fbar - exact) / dfn
    coverage = float((pull <= 2).mean())
    print(f"\nmax pull: {pull.max():.2f} sigma at n={pull.argmax()+1}; "
          f"2-sigma coverage {coverage:.2f}")
    return zmc, r, coverage


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="1e6 samples, 10 trials")
    ap.add_argument("--use-kernel", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to integrate (default: the card; raises without one)")
    args = ap.parse_args()
    main(args.device, full=args.full, use_kernel=args.use_kernel)
