"""Weights carried across between the reference and the port, both ways.

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

The other way, :meth:`Model.param_tree` lays the port's parameters out as
the reference's tree with each stage leaf a list of its layers' tensors,
and :func:`stack_tree` stacks every such list along axis 0:
:func:`reference_params` is the reference's parameter tree.  The
optimizer's state (``mu``, ``nu``; Adafactor's ``v`` / ``vr`` / ``vc``) and
the compression residuals are kept in the reference's layout from the
start (:mod:`repro_torch.optim.optimizers`), so the same :func:`stack_tree`
gives the reference's whole train state; the checkpoint writes list leaves
stacked in the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import flatten
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import is_stacked


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))         # a copy: jax's arrays are read-only


def params_from_reference(tree: dict, model: Model) -> Model:
    """Copy the reference's parameter ``tree`` into ``model`` (every key
    and shape must match) and return ``model``."""
    state = {}
    first = 0
    for stage in model.stages:
        for name, a in flatten(tree["stages"][stage.name]).items():
            if a.shape[0] != stage.n_layers:
                raise ValueError(f"stages.{stage.name}.{name}: {a.shape[0]} layers, "
                                 f"the model has {stage.n_layers}")
            for i in range(stage.n_layers):
                state[f"blocks.{first + i}.{name}"] = _tensor(a[i])
        first += stage.n_layers
    rest = {k: v for k, v in tree.items() if k != "stages"}
    state.update({k: _tensor(v) for k, v in flatten(rest).items()})
    model.load_state_dict(state, strict=True)
    return model


def stack_tree(tree):
    """``tree`` with every list leaf stacked along a new axis 0 and every
    leaf detached (the reference's layout of a parameter or state tree)."""
    if isinstance(tree, dict):
        return {k: stack_tree(v) for k, v in tree.items()}
    if is_stacked(tree):
        return torch.stack([t.detach() for t in tree])
    return tree.detach()


def reference_params(model: Model) -> dict:
    """The port's parameters as the reference's tree (copies: each stage
    leaf stacked along its ``layers`` axis)."""
    return stack_tree(model.param_tree())
