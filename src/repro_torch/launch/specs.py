"""Input structures for every model step (port of ``repro.launch.specs``).

``input_specs(cfg, shape)`` gives the shape and dtype of each input of the
step that a shape runs (train / prefill / decode), allocating nothing;
``concrete_batch`` makes a real batch with that structure from numpy's
``default_rng(seed)``, drawing in the reference's order, so its values
equal the reference's batch bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

# stub-frontend sizing: fraction of the sequence that is vision tokens
VISION_FRAC = 8  # 1/8 of the sequence


class Struct(NamedTuple):
    """Shape and dtype of one input (``jax.ShapeDtypeStruct``'s place)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def _batch_struct(cfg: ModelConfig, batch: int, seq: int, *, train: bool) -> dict:
    i32 = torch.int32
    cd = cfg.dtype("compute")
    if cfg.family == "encoder":
        d = {"frames": Struct((batch, seq, cfg.frontend_dim), cd)}
    elif cfg.family == "vlm":
        nv = max(1, seq // VISION_FRAC)
        d = {
            "tokens": Struct((batch, seq), i32),
            "vision_embeds": Struct((batch, nv, cfg.frontend_dim), cd),
            "positions": Struct((3, batch, seq), i32),
        }
    else:
        d = {"tokens": Struct((batch, seq), i32)}
    if train:
        d["labels"] = Struct((batch, seq), i32)
    return d


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Input structures of the step this shape runs."""
    if shape.kind == "train":
        return _batch_struct(cfg, shape.global_batch, shape.seq_len, train=True)
    if shape.kind == "prefill":
        return _batch_struct(cfg, shape.global_batch, shape.seq_len, train=False)
    if shape.kind == "decode":
        return {"tokens": Struct((shape.global_batch, 1), torch.int32),
                "pos": Struct((), torch.int32)}
    raise ValueError(shape.kind)


def batch_logical_axes(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Logical axes matching :func:`input_specs` (the reference's names)."""
    if shape.kind == "decode":
        return {"tokens": ("batch", None), "pos": ()}
    ax: dict = {}
    if cfg.family == "encoder":
        ax["frames"] = ("batch", "seq", "frontend")
    elif cfg.family == "vlm":
        ax["tokens"] = ("batch", "seq")
        ax["vision_embeds"] = ("batch", None, "frontend")
        ax["positions"] = (None, "batch", "seq")
    else:
        ax["tokens"] = ("batch", "seq")
    if shape.kind == "train":
        ax["labels"] = ("batch", "seq")
    return ax


def concrete_batch(cfg: ModelConfig, batch: int, seq: int, *, train: bool,
                   seed: int = 0, device=None) -> dict:
    """A real batch with the :func:`input_specs` structure, on ``device``
    (the card by default; raises without one)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, st in _batch_struct(cfg, batch, seq, train=train).items():
        if st.dtype.is_floating_point:
            a = torch.from_numpy(rng.standard_normal(st.shape).astype(np.float32))
        elif k == "positions":
            a = torch.arange(seq, dtype=torch.int32).expand(st.shape).contiguous()
        else:
            a = torch.from_numpy(rng.integers(0, cfg.vocab_size, st.shape, dtype=np.int32))
        out[k] = a.to(device=dev, dtype=st.dtype)
    return out
