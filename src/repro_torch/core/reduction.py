"""Numerically careful accumulation helpers (PyTorch port of
``repro.core.reduction``).

Long Monte-Carlo reductions accumulate in float32, so the port keeps
``repro``'s tools for it:

* **Welford/Chan** moment combination, so that (count, mean, M2) triples
  from different blocks, devices or restarts merge exactly;
* **Kahan** compensated accumulation across chunks;
* a **pairwise** (tree) sum with a defined association order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Moments(NamedTuple):
    """Streaming first and second moments of a batch of estimators.

    All fields share one shape.  ``m2`` is the sum of squared deviations
    (Welford's M2), *not* the variance.
    """
    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor

    @property
    def variance(self) -> torch.Tensor:
        return self.m2 / torch.clamp(self.count - 1.0, min=1.0)

    @property
    def stderr_of_mean(self) -> torch.Tensor:
        return torch.sqrt(self.variance / torch.clamp(self.count, min=1.0))


def moments_zero(shape, dtype=torch.float32, device=None) -> Moments:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return Moments(count=z, mean=z, m2=z)


def moments_from_sums(n, s1: torch.Tensor, s2: torch.Tensor) -> Moments:
    """Moments from raw (count, sum, sum of squares)."""
    n = torch.as_tensor(n, dtype=s1.dtype, device=s1.device)
    mean = s1 / torch.clamp(n, min=1.0)
    m2 = torch.clamp(s2 - n * torch.square(mean), min=0.0)
    return Moments(count=n, mean=mean, m2=m2)


def moments_combine(a: Moments, b: Moments) -> Moments:
    """Chan et al.'s parallel combination of two moment triples."""
    n = a.count + b.count
    safe_n = torch.clamp(n, min=1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * (b.count / safe_n)
    m2 = a.m2 + b.m2 + torch.square(delta) * (a.count * b.count / safe_n)
    return Moments(count=n, mean=mean, m2=m2)


class KahanAcc(NamedTuple):
    total: torch.Tensor
    comp: torch.Tensor


def kahan_zero(shape, dtype=torch.float32, device=None) -> KahanAcc:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return KahanAcc(total=z, comp=z)


def kahan_add(acc: KahanAcc, value: torch.Tensor) -> KahanAcc:
    """One compensated accumulation step (Kahan–Babuska)."""
    y = value - acc.comp
    t = acc.total + y
    comp = (t - acc.total) - y
    return KahanAcc(total=t, comp=comp)


def pairwise_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Pairwise (tree) reduction along ``dim``: neighbours summed level by
    level, an odd tail carried up, so the association order is defined."""
    x = torch.movedim(x, dim, -1)
    n = x.shape[-1]
    while n > 1:
        half = n // 2
        s = x[..., 0:2 * half:2] + x[..., 1:2 * half:2]
        if n % 2:
            s = torch.cat([s, x[..., -1:]], dim=-1)
        x = s
        n = x.shape[-1]
    return x[..., 0]
