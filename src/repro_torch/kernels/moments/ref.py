"""Plain oracle of the stratum-moments kernel (port of
``repro.kernels.moments.ref``)."""

from __future__ import annotations

import torch


def moments_ref(values: torch.Tensor) -> torch.Tensor:
    """f32[R, 3] (count, mean, M2) per row, by the direct two-pass
    formula over the whole row."""
    r, c = values.shape
    mean = torch.mean(values, dim=1)
    m2 = torch.sum(torch.square(values - mean[:, None]), dim=1)
    count = torch.full((r,), float(c), dtype=torch.float32,
                       device=values.device)
    return torch.stack([count, mean, m2], dim=1)
