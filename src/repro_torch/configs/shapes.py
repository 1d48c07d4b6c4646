"""Assigned input shapes and (arch x shape) cell validity.

Four shapes per LM architecture; ``decode_*``/``long_*`` lower
``serve_step`` (one new token against a seq_len cache), NOT ``train_step``.
Skips (the reference's dry-run emits them):

* ``long_500k`` needs a sub-quadratic serving path -> only SSM/hybrid run it;
* encoder-only archs (hubert) have no decode step -> skip decode shapes.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_status(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch, shape) cell."""
    if cfg.is_encoder and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500k decode needs a "
                       "sub-quadratic path (skip per assignment)")
    return True, ""


def runnable_cells(configs: dict[str, ModelConfig]):
    """All (arch_name, shape_name) cells that must pass the dry-run."""
    out = []
    for arch, cfg in configs.items():
        for sname, shape in SHAPES.items():
            ok, _ = cell_status(cfg, shape)
            if ok:
                out.append((arch, sname))
    return out
