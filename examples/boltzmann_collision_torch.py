"""The paper's physics motivation on the PyTorch port: batches of collision
integrals (``examples/boltzmann_collision.py``'s counterpart on
``repro_torch``).

Solving a Boltzmann equation with radiation requires, per energy beam and
per Feynman graph, a collision integral of the form

    C(p) = Int d^3q  W(p, q) [ f(q) (1 - f(p)) - f(p) (1 - f(q)) ]

Here we evaluate a (simplified, Maxwell-Juttner-weighted, 2->2 scattering)
gain-term kernel for MANY beam energies p and TWO "graphs" (s-channel-like
and t-channel-like angular weights) simultaneously: one
ZMCMultiFunctions call, exactly the workload class v5.1 was built for.
The graphs are the user's own integrands, written batched over the
function axis, and run on the chunked path.

    PYTHONPATH=src python examples/boltzmann_collision_torch.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np
import torch

from repro_torch.core import IntegrandFamily, MultiFunctionSpec, ZMCMultiFunctions

T = 1.0            # temperature (natural units)
N_BEAMS = 32       # energy beams -> one integrand per beam per graph


def gain_s_channel(x, prm):
    """x = (|q|, cos(theta), phi), (n_fn, B, 3); s-channel-ish
    |M|^2 ~ s^2/(s^2+1)."""
    q, ct, _ = x[..., 0], x[..., 1], x[..., 2]
    p = prm["p"][:, None]
    s_mand = 2 * p * q * (1 - ct) + 0.5          # massless-ish invariant
    m2 = torch.square(s_mand) / (torch.square(s_mand) + 1.0)
    flux = q * q / (torch.clamp(p, min=1e-3))
    return m2 * flux * torch.exp(-q / T) * (1 - 0.2 * torch.exp(-p / T))


def gain_t_channel(x, prm):
    """t-channel-ish: forward-peaked angular weight 1/(1 + (1-ct))^2."""
    q, ct, _ = x[..., 0], x[..., 1], x[..., 2]
    p = prm["p"][:, None]
    w = 1.0 / torch.square(2.0 - ct)
    flux = q * q / (torch.clamp(p, min=1e-3))
    return w * flux * torch.exp(-q / T) * (1 - 0.2 * torch.exp(-p / T))


def make_spec(n_beams: int = N_BEAMS) -> tuple[np.ndarray, MultiFunctionSpec]:
    """(beam momenta, both graphs over them)."""
    beam_p = np.linspace(0.2, 6.0, n_beams).astype(np.float32)
    # domain: |q| in [0, 8T] (thermal support), cos(theta) in [-1,1], phi in [0,2pi]
    dom = np.array([[0.0, 8.0], [-1.0, 1.0], [0.0, 2 * np.pi]], np.float32)
    domains = torch.from_numpy(np.broadcast_to(dom, (n_beams, 3, 2)).copy())
    params = {"p": torch.from_numpy(beam_p)}
    return beam_p, MultiFunctionSpec.from_families([
        IntegrandFamily(fn=gain_s_channel, params=params, domains=domains,
                        name="graph_s").validate(),
        IntegrandFamily(fn=gain_t_channel, params=params, domains=domains,
                        name="graph_t").validate(),
    ])


def main(device="cuda", n_samples: int = 200_000, num_trials: int = 3,
         n_beams: int = N_BEAMS):
    """Both graphs over ``n_beams`` beams, the reference script's report
    and its physics checks; returns ``(solver, result)``."""
    beam_p, spec = make_spec(n_beams)
    zmc = ZMCMultiFunctions(spec, n_samples=n_samples, seed=1, device=device)
    r = zmc.evaluate(num_trials=num_trials)

    cs = r.trial_mean[:n_beams]
    ct_ = r.trial_mean[n_beams:]
    print("beam p,   C_s-channel,   C_t-channel,   (rel stderr)")
    for i in range(0, n_beams, max(1, n_beams // 8)):
        rel = r.trial_std[i] / max(abs(cs[i]), 1e-9)
        print(f"{beam_p[i]:6.2f}   {cs[i]:12.5f}   {ct_[i]:12.5f}   ({rel:.1e})")

    # physics sanity: gain terms positive and decaying with beam energy at tail
    assert np.all(cs > 0) and np.all(ct_ > 0)
    assert cs[-1] < cs[n_beams // 2]
    print("OK: per-graph collision terms evaluated for all beams in one call")
    return zmc, r


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to integrate (default: the card; raises without one)")
    main(ap.parse_args().device)
