"""Quickstart on the PyTorch port: integrate many different functions at
once (``examples/quickstart.py``'s counterpart on ``repro_torch``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The multi-function solver takes *families*: one function batched over the
function axis plus stacked parameters.  The paper's harmonic series has a
registered kernel form; the second family is a user's own integrand, which
the solver evaluates on the chunked path (the same counter-based draws).
Runs on the card by default and raises without one; ``--device cpu`` runs
the same code on the CPU.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np
import torch

from repro_torch.core import (IntegrandFamily, MultiFunctionSpec,
                              ZMCMultiFunctions, harmonic_analytic,
                              harmonic_family)


def make_spec() -> MultiFunctionSpec:
    # -- family 1: the paper's harmonic series (Eq. 1), 50 integrands, dim 4 --
    harmonics = harmonic_family(50, 4)

    # -- family 2: your own integrands: f_c(x) = exp(-c |x|^2) over [-1, 2]^3;
    # x is (n_fn, B, 3), one row of samples per function, p["c"] is (n_fn,) --
    cs = torch.linspace(0.5, 4.0, 20)
    gauss = IntegrandFamily(
        fn=lambda x, p: torch.exp(-p["c"][:, None] * torch.sum(x * x, -1)),
        params={"c": cs},
        domains=torch.tensor([-1.0, 2.0]).expand(20, 3, 2).contiguous(),
        name="gauss3d",
    ).validate()
    return MultiFunctionSpec.from_families([harmonics, gauss])


def main(device="cuda", n_samples: int = 100_000, num_trials: int = 5):
    """Evaluate the spec ``num_trials`` times and print the reference
    script's report; returns ``(solver, result)``."""
    zmc = ZMCMultiFunctions(make_spec(), n_samples=n_samples, seed=0, device=device)
    result = zmc.evaluate(num_trials=num_trials)   # independent evaluations

    exact = harmonic_analytic(50, 4)
    print("first five harmonic modes (estimate +- spread vs analytic):")
    for i in range(5):
        print(f"  F_{i+1:<3d} = {result.trial_mean[i]:+.5f} "
              f"+- {result.trial_std[i]:.1e}   exact {exact[i]:+.5f}")

    cover = np.mean(np.abs(result.trial_mean[:50] - exact)
                    <= 2 * np.maximum(result.trial_std[:50], 1e-12))
    print(f"harmonics inside 2-sigma band: {100 * cover:.0f}%")
    print(f"gauss3d first/last: {result.trial_mean[50]:.5f} / "
          f"{result.trial_mean[-1]:.5f}")
    return zmc, result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to integrate (default: the card; raises without one)")
    main(ap.parse_args().device)
