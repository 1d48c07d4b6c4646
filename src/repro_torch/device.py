"""The device rule of the port.

Entry points default to the card: ``device=None`` means ``"cuda"``.  If no
GPU is present and the caller did not ask for ``"cpu"``, they raise; they
never move to the CPU on their own.  Kernels follow their tensors: CUDA
tensors launch the hand-written kernel, CPU tensors take its plain
PyTorch version (``repro_torch.kernels.template.fused_mc``).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch version on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu'; got {dev}")
    return dev
