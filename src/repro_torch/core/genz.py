"""Genz test-function families (PyTorch port of ``repro.core.genz``).

Six families with closed-form integrals over [0,1]^d.  Parameters (a, u)
are drawn from the framework's own Threefry stream, so they are
bit-identical to ``repro``'s; functions are batched over the function
axis (``x`` is (n_fn, B, dim), see ``repro_torch.core.integrand``).

Families (x in [0,1]^d; a, u parameter vectors):
  oscillatory   cos(2 pi u_1 + sum a_i x_i)
  product_peak  prod 1 / (a_i^-2 + (x_i - u_i)^2)
  corner_peak   (1 + sum a_i x_i)^-(d+1)
  gaussian      exp(-sum a_i^2 (x_i - u_i)^2)
  continuous    exp(-sum a_i |x_i - u_i|)
  discontinuous exp(sum a_i x_i) * [x_1 < u_1][x_2 < u_2]
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.integrand import IntegrandFamily


def _params(n: int, dim: int, seed: int, difficulty: float):
    """Reproducible (a, u) with sum(a) normalised to `difficulty`."""
    k0, k1 = rng_lib.fold_key(seed, stream=0x6E42)
    u = rng_lib.uniforms_for(k0, k1, np.arange(n), np.arange(dim), 1
                             ).numpy()[:, :, 0]
    a_raw = rng_lib.uniforms_for(k0, k1, np.arange(n) + (1 << 20),
                                 np.arange(dim), 1).numpy()[:, :, 0] + 0.1
    a = a_raw * (difficulty / a_raw.sum(axis=1, keepdims=True))
    return a.astype(np.float32), u.astype(np.float32)


def _family(fn, a, u, name, kernel=None, device="cpu"):
    n, dim = a.shape
    dom = np.broadcast_to(np.asarray([0.0, 1.0], np.float32), (n, dim, 2))
    t = lambda x: torch.from_numpy(np.array(x, np.float32)).to(device)
    return IntegrandFamily(
        fn=fn, params={"a": t(a), "u": t(u)}, domains=t(dom), name=name,
        kernel=kernel).validate()


def _a(p):
    return p["a"][:, None, :]


def _u(p):
    return p["u"][:, None, :]


# -- oscillatory -------------------------------------------------------------

def oscillatory_fn(x, p):
    return torch.cos(2 * math.pi * p["u"][:, None, 0]
                     + torch.sum(_a(p) * x, dim=-1))


def oscillatory(n: int, dim: int, seed: int = 0, difficulty: float = 9.0,
                device="cpu"):
    a, u = _params(n, dim, seed, difficulty)
    # exact: Re[e^{i 2pi u1} prod (e^{i a_j} - 1)/(i a_j)]
    phase = 2 * np.pi * u[:, 0] + a.sum(1) / 2
    mag = np.prod(2 * np.sin(a / 2) / a, axis=1)
    exact = mag * np.cos(phase)
    return _family(oscillatory_fn, a, u, f"genz_osc[{n}x{dim}]",
                   kernel="mc_eval_genz_osc", device=device), exact


# -- product peak -------------------------------------------------------------

def product_peak_fn(x, p):
    return torch.prod(1.0 / (_a(p) ** -2 + torch.square(x - _u(p))), dim=-1)


def product_peak(n: int, dim: int, seed: int = 1, difficulty: float = 7.25,
                 device="cpu"):
    a, u = _params(n, dim, seed, difficulty)
    exact = np.prod(a * (np.arctan(a * (1 - u)) + np.arctan(a * u)), axis=1)
    return _family(product_peak_fn, a, u, f"genz_peak[{n}x{dim}]",
                   device=device), exact


# -- corner peak --------------------------------------------------------------

def corner_peak_fn(x, p):
    return (1.0 + torch.sum(_a(p) * x, dim=-1)) ** (-(x.shape[-1] + 1.0))


def corner_peak(n: int, dim: int, seed: int = 2, difficulty: float = 1.85,
                device="cpu"):
    a, u = _params(n, dim, seed, difficulty)
    # exact via inclusion-exclusion:
    #   (d! prod a_i)^-1 sum_{S subset [d]} (-1)^|S| (1 + sum_{i in S} a_i)^-1
    exact = np.zeros(n)
    for i in range(n):
        total = 0.0
        for mask in range(1 << dim):
            s = bin(mask).count("1")
            sub = sum(a[i, j] for j in range(dim) if (mask >> j) & 1)
            total += (-1.0) ** s / (1.0 + sub)
        exact[i] = total / (math.factorial(dim) * np.prod(a[i]))
    return _family(corner_peak_fn, a, u, f"genz_corner[{n}x{dim}]",
                   kernel="mc_eval_genz_corner", device=device), exact


# -- gaussian ------------------------------------------------------------------

def _erf(x):
    # Abramowitz-Stegun 7.1.26, |err| < 1.5e-7 — keeps numpy-only
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
                - 0.284496736) * t + 0.254829592) * t * np.exp(-x * x)
    return sign * y


def gaussian_peak_fn(x, p):
    return torch.exp(-torch.sum(torch.square(_a(p) * (x - _u(p))), dim=-1))


def gaussian_peak(n: int, dim: int, seed: int = 3, difficulty: float = 7.03,
                  device="cpu"):
    a, u = _params(n, dim, seed, difficulty)
    exact = np.prod(np.sqrt(np.pi) / (2 * a)
                    * (_erf(a * (1 - u)) + _erf(a * u)), axis=1)
    return _family(gaussian_peak_fn, a, u, f"genz_gauss[{n}x{dim}]",
                   device=device), exact


# -- continuous (C0) -----------------------------------------------------------

def continuous_fn(x, p):
    return torch.exp(-torch.sum(_a(p) * torch.abs(x - _u(p)), dim=-1))


def continuous(n: int, dim: int, seed: int = 4, difficulty: float = 2.04,
               device="cpu"):
    a, u = _params(n, dim, seed, difficulty)
    exact = np.prod((2.0 - np.exp(-a * u) - np.exp(-a * (1 - u))) / a, axis=1)
    return _family(continuous_fn, a, u, f"genz_cont[{n}x{dim}]",
                   device=device), exact


# -- discontinuous --------------------------------------------------------------

def discontinuous_fn(x, p):
    u = _u(p)
    inside = x[..., 0] < u[..., 0]
    if x.shape[-1] > 1:
        inside = inside & (x[..., 1] < u[..., 1])
    return torch.where(inside, torch.exp(torch.sum(_a(p) * x, dim=-1)),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def discontinuous(n: int, dim: int, seed: int = 5, difficulty: float = 4.3,
                  device="cpu"):
    a, u = _params(n, dim, seed, difficulty)
    exact = np.ones(n)
    for j in range(dim):
        hi = u[:, j] if j < 2 else 1.0
        exact *= (np.exp(a[:, j] * hi) - 1.0) / a[:, j]
    return _family(discontinuous_fn, a, u, f"genz_disc[{n}x{dim}]",
                   device=device), exact


ALL = {
    "oscillatory": oscillatory,
    "product_peak": product_peak,
    "corner_peak": corner_peak,
    "gaussian": gaussian_peak,
    "continuous": continuous,
    "discontinuous": discontinuous,
}
