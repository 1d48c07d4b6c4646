"""Per-row streaming moments of a (strata, samples) value matrix: the
dispatcher, the CUDA wrapper and the plain PyTorch version (port of
``repro.kernels.moments.ops`` and ``kernel``).

:func:`stratum_moments` requires a multiple of ``C_BLK = 512`` samples
per row (padding columns would bias the variance), pads rows to a
multiple of ``R_BLK = 8`` with zeros and slices them off.  Within each
512-column block the mean and M2 are two-pass; the blocks fold in column
order with the Chan/Welford merge, as ``repro``'s ``_moments_kernel``
folds its column grid axis.  CPU tensors take :func:`moments_plain`,
CUDA tensors :func:`moments_cuda` (``csrc/moments.cu``); anything else
raises, and nothing falls back from the kernel to the plain version.
"""

from __future__ import annotations

import math
import threading

import torch
import torch.nn.functional as F

from repro_torch.core.reduction import Moments

R_BLK = 8     # rows per block (the padding quantum)
C_BLK = 512   # samples per column block

_COUNT_LOCK = threading.Lock()
_LAUNCHES = 0   # launches of the CUDA kernel


def kernel_launch_count() -> int:
    """Launches of the CUDA kernel since the last reset."""
    return _LAUNCHES


def reset_kernel_launch_count() -> None:
    global _LAUNCHES
    with _COUNT_LOCK:
        _LAUNCHES = 0


def stratum_moments(values: torch.Tensor) -> Moments:
    """Per-row Moments of an f32 (n_strata, n_samples) value matrix.

    ``n_samples`` must be a multiple of ``C_BLK``; rows are padded to a
    multiple of ``R_BLK`` with zeros and sliced off after.
    """
    values = values.to(torch.float32)
    if values.ndim != 2:
        raise ValueError(f"values must be 2-d (strata, samples); got "
                         f"{tuple(values.shape)}")
    r, c = values.shape
    if c == 0 or c % C_BLK != 0:
        raise ValueError(
            f"n_samples per stratum must be a multiple of {C_BLK}; got {c}")
    r_pad = math.ceil(r / R_BLK) * R_BLK
    if r_pad != r:
        values = F.pad(values, [0, 0, 0, r_pad - r])
    kind = values.device.type
    if kind == "cuda":
        out = moments_cuda(values)
    elif kind == "cpu":
        out = moments_plain(values)
    else:
        raise ValueError(f"stratum_moments runs on 'cuda' or 'cpu' tensors; "
                         f"got {kind!r}")
    out = out[:r]
    return Moments(count=out[:, 0], mean=out[:, 1], m2=out[:, 2])


def moments_plain(values: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32[R, 3] (count, mean, M2)
    per row of f32[R, C], C a multiple of ``C_BLK``."""
    r, c = values.shape
    blocks = values.reshape(r, c // C_BLK, C_BLK)
    mean_b = blocks.mean(dim=-1)
    m2_b = torch.square(blocks - mean_b[..., None]).sum(dim=-1)
    n_b = float(C_BLK)
    n, mean, m2 = n_b, mean_b[:, 0], m2_b[:, 0]
    for j in range(1, c // C_BLK):
        tot = n + n_b
        delta = mean_b[:, j] - mean
        mean = mean + delta * (n_b / tot)
        m2 = m2 + m2_b[:, j] + torch.square(delta) * (n * n_b / tot)
        n = tot
    count = torch.full((r,), float(n), dtype=torch.float32,
                       device=values.device)
    return torch.stack([count, mean, m2], dim=1)


def moments_cuda(values: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/moments.cu`` on the current stream: f32[R, 3] per
    row of a contiguous f32[R, C] CUDA tensor, C a positive multiple of
    ``C_BLK``.  Raises if the launch reports a CUDA error; nothing here
    waits for the card."""
    from repro_torch.kernels import build
    global _LAUNCHES
    if values.device.type != "cuda":
        raise ValueError(f"moments_cuda needs a CUDA tensor; got {values.device}")
    if values.dtype != torch.float32 or values.ndim != 2:
        raise ValueError(f"values must be 2-d float32; got {values.dtype} "
                         f"{tuple(values.shape)}")
    r, c = values.shape
    if r == 0 or c == 0 or c % C_BLK:
        raise ValueError(f"values must be (R > 0, C > 0 a multiple of "
                         f"{C_BLK}); got {tuple(values.shape)}")
    values = values.contiguous()
    if values.data_ptr() % 16:            # the kernel reads rows as float4
        values = values.clone()
    lib = build.load("zmc_moments")
    if lib.zmc_moments_cblk() != C_BLK:
        raise RuntimeError("csrc/moments.cu C_BLK disagrees with ops.C_BLK")
    out = torch.empty(r, 3, dtype=torch.float32, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = lib.zmc_stratum_moments(values.data_ptr(), r, c, out.data_ptr(),
                                      stream)
    if err != 0:
        raise RuntimeError(f"zmc_stratum_moments launch failed with CUDA "
                           f"error {err}")
    with _COUNT_LOCK:
        _LAUNCHES += 1
    return out
