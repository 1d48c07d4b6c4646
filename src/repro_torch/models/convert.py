"""Weights carried across from the reference.

:func:`params_from_reference` loads the reference's parameter tree (the
nested dict of ``Model.init``, its leaves as numpy arrays:
``jax.tree.map(np.asarray, params)``) into a port :class:`Model`.  The two
packages keep the same weight layouts, so each leaf is a copy; the stacked
``stages/<stage>`` leaves (a leading ``layers`` axis) are split along axis 0
into the blocks, stage after stage (``layers``; ``dense_layers`` then
``moe_layers``; the hybrid's ``groups`` then ``tail``), and the other
subtrees (``embed``, the hybrid's one ``shared_attn`` block,
``final_norm``, ``head``, the multi-token-prediction ``mtp``) are copied
as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import Model


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))         # a copy: jax's arrays are read-only


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def params_from_reference(tree: dict, model: Model) -> Model:
    """Copy the reference's parameter ``tree`` into ``model`` (every key
    and shape must match) and return ``model``."""
    state = {}
    first = 0
    for stage in model.stages:
        for name, a in _flatten(tree["stages"][stage.name]).items():
            if a.shape[0] != stage.n_layers:
                raise ValueError(f"stages.{stage.name}.{name}: {a.shape[0]} layers, "
                                 f"the model has {stage.n_layers}")
            for i in range(stage.n_layers):
                state[f"blocks.{first + i}.{name}"] = _tensor(a[i])
        first += stage.n_layers
    rest = {k: v for k, v in tree.items() if k != "stages"}
    state.update({k: _tensor(v) for k, v in _flatten(rest).items()})
    model.load_state_dict(state, strict=True)
    return model
