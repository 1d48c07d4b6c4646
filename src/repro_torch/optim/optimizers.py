"""Optimizers from scratch (port of ``repro.optim.optimizers``): AdamW and
Adafactor.

Both keep the reference's functional interface::

  init(params)                         -> opt state
  update(grads, state, params, step)   -> (params, state)

over trees of nested dicts.  A leaf is a tensor, or a list of same-shaped
tensors that stands for their stack along a new leading axis: the port
holds a stage's blocks one module per layer, where the reference stacks
each stage leaf along its ``layers`` axis (``Model.param_tree``).  The
state is laid out as the reference's, one tensor per leaf, stacked where
the leaf is a list, so it is checkpointed and compared leaf for leaf.  A
list leaf holds at least one tensor: a stage of no layers is a tensor leaf
of shape ``(0, ...)`` (``Model.param_tree``).

``update`` runs under ``torch.no_grad()`` and updates the parameters and
the state in place (a parameter held by a module stays that module's),
leaf by leaf, so no second copy of the parameter tree is ever alive.  The
arithmetic is the reference's, in its order: AdamW's ``mu_hat /
(sqrt(nu_hat) + eps) + wd * p``, then ``p - lr * upd`` in f32, cast back
to the parameter's dtype; not ``torch.optim.AdamW``, which decays by
``p *= 1 - lr * wd`` and divides ``sqrt(nu)`` by ``sqrt(c2)``: the same
mathematics rounded differently.  A python constant meets a tensor
rounded to that tensor's dtype first, as a weakly typed scalar does in the
reference (``b1 * mu`` with bf16 moments multiplies by bf16(0.9)).

Adafactor (Shazeer & Stern 2018) keeps factored second moments, O(n+m)
per (n, m) matrix; which leaves it factors and the RMS of its update clip
are those of the reference's stacked leaf, so a list leaf is stacked for
its update and copied back layer by layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.tree import tree_leaves
from repro_torch.optim.schedule import constant


@dataclasses.dataclass(frozen=True)
class Optimizer:
    kind: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple[Any, Any]]


def _schedule_fn(lr):
    return lr if callable(lr) else constant(lr)


def is_stacked(leaf) -> bool:
    """A list (or tuple) leaf: the stack of its tensors along axis 0."""
    return isinstance(leaf, (list, tuple))


def leaf_shape(leaf) -> tuple[int, ...]:
    """The reference's shape of a leaf (a list leaf's stacked shape)."""
    if is_stacked(leaf):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def map_leaves(fn: Callable, tree, *others):
    """``fn(leaf, *matching leaves of others)`` over the dict structure of
    ``tree``; tensors and list leaves are leaves."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    return fn(tree, *others)


def weak_scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: a weakly typed python scalar meeting a
    tensor of that dtype."""
    return float(torch.tensor(x, dtype=dtype))


def _zeros(leaf, dtype, shape=None) -> torch.Tensor:
    dev = (leaf[0] if is_stacked(leaf) else leaf).device
    return torch.zeros(leaf_shape(leaf) if shape is None else shape, dtype=dtype, device=dev)


def _step_f32(step, like) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32, device=like.device)


def _first(tree) -> torch.Tensor:
    leaf = tree_leaves(tree)[0]
    return leaf[0] if is_stacked(leaf) else leaf


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, moment_dtype=torch.float32) -> Optimizer:
    sched = _schedule_fn(lr)
    md = moment_dtype
    b1_m, b2_m = weak_scalar(b1, md), weak_scalar(b2, md)
    c1_m, c2_m = weak_scalar(1 - b1, md), weak_scalar(1 - b2, md)

    def init(params):
        zeros = lambda p: _zeros(p, md)
        return {"mu": map_leaves(zeros, params), "nu": map_leaves(zeros, params)}

    def one(g, mu, nu, p, c1, c2, lr_t):
        gf = g.to(md)
        mu.mul_(b1_m).add_(gf * c1_m)
        nu.mul_(b2_m).add_(torch.square(gf).mul_(c2_m))
        upd = mu.float() / c1
        upd.div_((nu.float() / c2).sqrt_().add_(eps))
        upd.add_(p.float() * weight_decay)
        upd.mul_(lr_t)
        if p.dtype == torch.float32:
            p.sub_(upd)
        else:
            p.copy_(p.float().sub_(upd))

    @torch.no_grad()
    def update(grads, state, params, step):
        stepf = _step_f32(step, _first(params)) + 1.0
        lr_t = sched(step)
        c1 = 1.0 - torch.pow(b1, stepf)
        c2 = 1.0 - torch.pow(b2, stepf)

        def leaf(g, mu, nu, p):
            if is_stacked(p):
                for i, (gi, pi) in enumerate(zip(g, p, strict=True)):
                    one(gi, mu[i], nu[i], pi, c1, c2, lr_t)
            else:
                one(g, mu, nu, p, c1, c2, lr_t)

        map_leaves(leaf, grads, state["mu"], state["nu"], params)
        return params, state

    return Optimizer(kind="adamw", init=init, update=update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, no first moment)
# ---------------------------------------------------------------------------

def adafactor(lr, *, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0,
              min_dim_size_to_factor: int = 128) -> Optimizer:
    sched = _schedule_fn(lr)
    f32 = torch.float32

    def _factored(shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def init(params):
        def one(p):
            shape = leaf_shape(p)
            if _factored(shape):
                return {"vr": _zeros(p, f32, shape[:-1]),
                        "vc": _zeros(p, f32, shape[:-2] + shape[-1:])}
            return {"v": _zeros(p, f32)}
        return map_leaves(one, params)

    @torch.no_grad()
    def update(grads, state, params, step):
        stepf = _step_f32(step, _first(params)) + 1.0
        lr_t = sched(step)
        beta = 1.0 - torch.pow(stepf, -decay)   # increasing decay schedule

        def one(g, s, p):
            stacked = is_stacked(p)
            pt = torch.stack(list(p)) if stacked else p
            gf = (torch.stack(list(g)) if stacked else g).float()
            g2 = torch.square(gf) + eps
            if _factored(pt.shape):
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1))
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2))
                vr, vc = s["vr"], s["vc"]
                row_mean = torch.mean(vr, dim=-1, keepdim=True)
                precond = (vr / torch.clamp(row_mean, min=eps))[..., None] * vc.unsqueeze(-2)
                upd = gf / torch.sqrt(torch.clamp(precond, min=eps))
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                upd = gf / torch.sqrt(torch.clamp(s["v"], min=eps))
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-30)
            upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
            pf = pt.float()
            new_p = pf - lr_t * (upd + weight_decay * pf)
            if stacked:
                for i, pi in enumerate(p):
                    pi.copy_(new_p[i])
            else:
                p.copy_(new_p)

        map_leaves(one, grads, state, params)
        return params, state

    return Optimizer(kind="adafactor", init=init, update=update)


def opt_state_specs(kind: str, abstract_params, param_specs,
                    min_dim_size_to_factor: int = 128):
    """Logical-axes tree for the optimizer state of ``kind``.

    Needs the abstract params (leaves with a ``shape``) because Adafactor's
    factorisation depends on leaf shapes, not just axes."""
    if kind == "adamw":
        return {"mu": map_leaves(lambda p, a: tuple(a), abstract_params, param_specs),
                "nu": map_leaves(lambda p, a: tuple(a), abstract_params, param_specs)}
    if kind == "adafactor":
        def one(p, axes):
            shape = leaf_shape(p)
            if (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                    and shape[-2] >= min_dim_size_to_factor):
                return {"vr": tuple(axes[:-1]), "vc": tuple(axes[:-2]) + (axes[-1],)}
            return {"v": tuple(axes)}
        return map_leaves(one, abstract_params, param_specs)
    raise ValueError(kind)


def make_optimizer(kind: str, lr, **kw) -> Optimizer:
    if kind == "adamw":
        return adamw(lr, **kw)
    if kind == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(kind)
