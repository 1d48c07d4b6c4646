"""A model whose parameters rest as this rank's shards: tensor parallel
over ``model`` where the reference's rules shard a head, width or vocab
dim there, gathered over every other axis of their spec before use (the
LM multi-device path's schedule where the reference leaves collectives to
XLA's partitioner).

:func:`shard_model` replaces every parameter of a :class:`Model` by the
block of it that this rank's mesh position owns under the reference's
spec (``logical_to_spec(stacked shape, ("layers",) + axes, mesh, rules,
param_retry=True)``; the rules never shard ``layers``, so a stage leaf's
per-layer tensor takes that spec without its first entry).  The values
are one device's: each leaf is drawn in :func:`init_params`' order from
the same seeded generator and cut, a stage leaf one layer at a time (ranks
that share a card take turns, so one layer's f32 draw is the only
transient).

:func:`leaf_role` is the one placement rule that this module, the train
step and the dry run read.  ``"local"``: the leaf keeps its ``model``
block, and the layer computes on it (the heads of q/k/v/o, the MLP's and
shared experts' width, the vocab of the embedding and head, the SSM's
heads and inner width, the routed experts under expert parallelism).
``"partial"``: the leaf is gathered whole, but each ``model`` rank uses it
for its own block (K/V weights where the q group is split, MLA's latents,
the SSM's B/C, the router of the expert-parallel island), so its gradient
sums over ``model`` too.  ``None``: gathered whole, used alike on every
``model`` rank.  Where the heads split neither by KV head nor by q group
(the reference's q-sequence case, ``attn_q_seq``: context parallelism,
:mod:`repro_torch.models.layers`), each rank computes its own query rows,
so every attention leaf that feeds the scores is ``"partial"`` (q's, and
K/V's, whose gradient comes from this rank's rows only); ``wo`` is
``"local"`` where the heads split (it stays row-split) and ``None`` where
they are whole (the rows are gathered before it, which then runs alike on
every rank).

:class:`Gatherer` is the model's ``param_source``: ``entry(block)``
swaps each parameter of one plan entry for its gathered tensor
(:func:`gather_leaf`) for the entry's forward, and for its recompute in
backward under remat; ``top()`` does the same for the embedding, final
norm, head and ``mtp`` around a microbatch's forward and backward.  The
gather's backward is the gradient's deterministic reduce-scatter over the
ranks whose contributions differ (the batch axes, and ``model`` for a
``"partial"`` leaf): each rank keeps the sum of its block, folded in rank
order.  Serving keeps the same blocks and gathers at every step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.models import layers, moe
from repro_torch.models.config import _init_leaf, flatten


def batch_axes(mesh, rules, rows: int, seq: int = 1) -> tuple[str, ...]:
    """The mesh axes a (rows, seq) batch's rows split over."""
    spec = sh.logical_to_spec((rows, seq), ("batch", "seq"), mesh, rules)
    return sh.spec_axes(spec[0]) if spec else ()


def member_coords(mesh, axes, coord: dict[str, int]) -> list[dict[str, int]]:
    """The positions along ``axes`` (row-major) at ``coord`` elsewhere."""
    out = [dict(coord)]
    for a, n in sh.mesh_axes(mesh).items():
        if a in axes:
            out = [dict(c, **{a: i}) for c in out for i in range(n)]
    return out


@dataclasses.dataclass
class LeafPlan:
    """How one parameter tensor is held, gathered and reduced."""
    spec: tuple                  # its at-rest spec (per-layer tensor)
    gather_axes: tuple           # axes gathered before use
    sum_axes: tuple              # axes its gradient is summed over
    gathered_shape: tuple        # the tensor after the gather
    parts: list                  # gather: each member's block of the result
    pieces: list                 # reduce-scatter: each member's block of the gradient
    module: nn.Module | None = None
    key: str = ""


def _sub_spec(spec, axes) -> tuple:
    out = []
    for e in spec:
        ax = sh.spec_axes(e)
        if ax and set(ax) <= set(axes):
            out.append(e)
        elif ax and set(ax) & set(axes):
            raise ValueError(f"spec entry {e} is gathered in part over {axes}")
        else:
            out.append(None)
    return tuple(out)


def leaf_plan(full_shape, spec, mesh, gather_axes, sum_axes, coord) -> LeafPlan:
    sizes = sh.mesh_axes(mesh)
    gather_axes = tuple(a for a in sizes if a in gather_axes and sizes[a] > 1)
    sum_axes = tuple(a for a in sizes if a in sum_axes and sizes[a] > 1)
    sub = _sub_spec(spec, gather_axes)
    gathered = tuple(s // math.prod(sizes[a] for a in sh.spec_axes(e)
                                    if a not in gather_axes)
                     for s, e in zip(full_shape, tuple(spec) + (None,) * len(full_shape)))
    parts = [sh.shard_slices(gathered, sub, mesh, c)
             for c in member_coords(mesh, gather_axes, coord)]
    pieces = [sh.shard_slices(gathered, sub, mesh, c)
              for c in member_coords(mesh, sum_axes, coord)]
    return LeafPlan(tuple(spec), gather_axes, sum_axes, gathered, parts, pieces)


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, mesh, plan):
        ctx.mesh, ctx.plan = mesh, plan
        if not plan.gather_axes:
            return shard.clone()
        full = torch.empty(plan.gathered_shape, dtype=shard.dtype, device=shard.device)
        for part, where in zip(collectives.all_gather_axes(shard, mesh, plan.gather_axes),
                               plan.parts, strict=True):
            full[where] = part
        return full

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        return collectives.reduce_scatter_fixed(g, ctx.mesh, plan.sum_axes, plan.pieces), None, None


def gather_leaf(shard: torch.Tensor, mesh, plan: LeafPlan) -> torch.Tensor:
    """The tensor gathered over ``plan.gather_axes``; its gradient is summed
    over ``plan.sum_axes`` (in rank order) and cut back to ``shard``'s block."""
    return _GatherLeaf.apply(shard, mesh, plan)


def _stacked_spec(shape, axes, mesh, rules) -> tuple:
    return sh.logical_to_spec(shape, axes, mesh, rules, param_retry=True)


def _first_blocks(model) -> dict[str, int]:
    """Each stage's first index in ``model.blocks``."""
    first, n = {}, 0
    for s in model.stages:
        first[s.name] = n
        n += s.n_layers
    return first


def param_layout(model, mesh, rules) -> dict[str, tuple]:
    """``{parameter name: (per-layer shape, per-layer spec)}`` for every
    parameter of ``model`` (anything with its ``cfg`` and ``stages``),
    from the reference's (stacked) specs."""
    from repro_torch.models.model import param_defs
    out = {}
    first = _first_blocks(model)
    for name, p in flatten(param_defs(model.cfg)).items():
        spec = _stacked_spec(p.shape, p.axes, mesh, rules)
        if name.startswith("stages."):
            _, stage, rest = name.split(".", 2)
            if spec and spec[0] is not None:
                raise ValueError(f"{name}: the layers axis is sharded ({spec})")
            per = tuple(spec[1:])
            for i in range(p.shape[0]):
                out[f"blocks.{first[stage] + i}.{rest}"] = (tuple(p.shape[1:]), per)
        else:
            out[name] = (tuple(p.shape), spec)
    return out


_ATTN_Q = frozenset({"wq", "bq", "wo"})
_MLA_HEADS = frozenset({"wq", "wq_b", "wk_b", "wv_b", "wo"})
_SSM_SHARED = frozenset({"wB", "wC", "conv_B", "conv_C"})


def leaf_role(cfg, mesh, rules, name: str) -> str | None:
    """The placement of the parameter leaf ``name`` (dotted, as
    ``Model.named_parameters`` or :func:`param_layout` names it):
    ``"local"``, ``"partial"`` or None (see the module docstring)."""
    ep = moe.ep_role(cfg, mesh, name)
    if ep is not None:
        return "partial" if ep == "router" else ep
    parts = name.split(".")
    key, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
    tp = lambda logical, dim: sh.tp_ways(mesh, rules, logical, dim) > 1
    if (parts[0], key) in (("embed", "tok"), ("head", "out")):
        return "local" if tp("vocab", cfg.vocab_padded) else None
    if parent == "attn":
        mla = cfg.attn_type == "mla"
        mode = layers.attn_mode(mesh, rules, cfg.n_heads,
                                cfg.n_heads if mla else cfg.n_kv_heads)
        if mode == "kv":
            return "local" if not mla or key in _MLA_HEADS else "partial"
        if mode in ("qgroup", "qseq_heads"):
            return "local" if key in _ATTN_Q else "partial"
        if mode == "qseq":
            return None if key == "wo" else "partial"
        return None
    if parent == "shared" and parts[-3] == "ffn":
        return "local" if tp("shared_mlp", cfg.n_shared_experts * cfg.moe_d_ff) else None
    if parent == "ffn" and key in ("wg", "wu", "wd"):
        if parts[0] == "blocks" and moe.is_moe_layer(cfg, int(parts[1])):
            return None      # routed experts without expert parallelism
        return "local" if tp("mlp", cfg.d_ff) else None
    if parent == "mixer":
        if not (tp("mlp", cfg.ssm_d_inner) and tp("ssm_heads", cfg.ssm_heads)):
            return None
        return "partial" if key in _SSM_SHARED else "local"
    return None


def init_shards(model, mesh, rules, *, seed: int, device, dtype) -> dict[str, torch.Tensor]:
    """This rank's block of every parameter, drawn as :func:`init_params`
    draws the whole model from ``seed`` (so one device's values), one leaf
    at a time and a stage leaf one layer at a time."""
    from repro_torch.models.model import param_defs
    coord = collectives._coord(mesh)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    first = _first_blocks(model)
    out: dict[str, torch.Tensor] = {}
    for name, p in flatten(param_defs(model.cfg)).items():
        spec = _stacked_spec(p.shape, p.axes, mesh, rules)
        where = sh.shard_slices(p.shape, spec, mesh, coord)
        stacked = name.startswith("stages.")
        if p.init == "normal":
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
            std = p.scale if p.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
            if stacked:
                block = [torch.randn(p.shape[1:], generator=gen, dtype=torch.float32,
                                     device=device)[where[1:]].mul(std).to(dtype)
                         for _ in range(p.shape[0])]
            else:
                draw = torch.randn(p.shape, generator=gen, dtype=torch.float32, device=device)
                block = draw[where].mul(std).to(dtype)
                del draw
        else:
            local = dataclasses.replace(p, shape=sh.shard_shape(p.shape, spec, mesh))
            block = _init_leaf(local, gen, dtype, device)
            block = list(block.unbind(0)) if stacked else block
        if stacked:
            _, stage, rest = name.split(".", 2)
            for i, t in enumerate(block):
                out[f"blocks.{first[stage] + i}.{rest}"] = t.contiguous().clone()
        else:
            out[name] = block.contiguous()
    return out


def init_transient_bytes(cfg) -> int:
    """The largest f32 draw of :func:`init_shards` (and of one device's
    ``Model(cfg, seed)``): one layer of a stage leaf, or a whole top-level
    leaf."""
    from repro_torch.models.model import param_defs
    return max(4 * math.prod(p.shape[1:] if n.startswith("stages.") else p.shape)
               for n, p in flatten(param_defs(cfg)).items() if p.init == "normal")


def _owner(model, name: str) -> tuple[nn.Module, str]:
    prefix, _, key = name.rpartition(".")
    return model.get_submodule(prefix), key


def shard_model(model, mesh, rules=None, *, seed: int = 0, device=None,
                shards: dict[str, torch.Tensor] | None = None):
    """Give ``model`` (built on ``meta``) this rank's parameter blocks
    (drawn from ``seed`` unless ``shards`` are given) and a
    :class:`Gatherer` as its ``param_source``; returns ``model``."""
    rules = sh.rules_for(model.cfg) if rules is None else rules
    device = collectives.mesh_device(mesh, device)
    dtype = next(model.parameters()).dtype
    if shards is None:
        # ranks on one card take turns: one leaf's whole draw at a time
        turns = device.type == "cuda" and dist.get_world_size() > 1
        for r in range(dist.get_world_size() if turns else 1):
            if not turns or dist.get_rank() == r:
                shards = init_shards(model, mesh, rules, seed=seed, device=device, dtype=dtype)
                if turns:
                    torch.cuda.empty_cache()
            if turns:
                dist.barrier()
    for name, t in shards.items():
        mod, key = _owner(model, name)
        mod._parameters[key] = nn.Parameter(t)
    model.param_source = Gatherer(model, mesh, rules)
    return model


class Gatherer:
    """Swaps a model's parameter shards for whole tensors around their use
    (see the module docstring)."""

    def __init__(self, model, mesh, rules):
        self.mesh, self.rules = mesh, rules
        self.cfg = model.cfg
        self.coord = collectives._coord(mesh)
        self.batch_axes: tuple = ()
        self.model = model
        self.layout = param_layout(model, mesh, rules)
        self._plans: dict = {}
        self._names: dict = {}

    def set_batch(self, rows: int, seq: int) -> None:
        """The microbatch shape: its batch axes are the gradient's sum axes."""
        axes = batch_axes(self.mesh, self.rules, rows, seq)
        if axes != self.batch_axes:
            self.batch_axes = axes
            self._plans = {}

    def plan(self, name: str) -> LeafPlan:
        if name not in self._plans:
            shape, spec = self.layout[name]
            gather = sh.sharded_axes(spec)
            sums = self.batch_axes
            role = leaf_role(self.cfg, self.mesh, self.rules, name)
            if role == "local":
                if "model" not in gather:
                    raise ValueError(f"{name}: a tensor-parallel leaf whose spec {spec} "
                                     f"does not shard 'model'")
                gather = tuple(a for a in gather if a != "model")
            elif role == "partial":
                sums = tuple(sums) + ("model",)
            plan = leaf_plan(shape, spec, self.mesh, gather, sums, self.coord)
            plan.module, plan.key = _owner(self.model, name)
            self._plans[name] = plan
        return self._plans[name]

    @contextlib.contextmanager
    def _swap(self, names):
        # a leaf neither gathered nor (under grad) summed is used as it rests
        grad = torch.is_grad_enabled()
        plans = [p for p in map(self.plan, names) if p.gather_axes or (grad and p.sum_axes)]
        kept = [p.module._parameters[p.key] for p in plans]
        try:
            for p, shard in zip(plans, kept):
                p.module._parameters[p.key] = gather_leaf(shard, self.mesh, p)
            yield
        finally:
            for p, shard in zip(plans, kept):
                p.module._parameters[p.key] = shard

    def entry(self, block):
        key = id(block)
        if key not in self._names:
            prefix = self._prefix(block)
            self._names[key] = [f"{prefix}.{n}" for n, _ in block.named_parameters()]
        return self._swap(self._names[key])

    def top(self, serving: bool = False):
        """The embedding, final norm and head (and ``mtp``, which serving
        does not read) gathered around the caller's use."""
        skip = ("blocks.", "shared_attn.") + (("mtp.",) if serving else ())
        return self._swap([n for n in self.layout if not n.startswith(skip)])

    def _prefix(self, block) -> str:
        if block is self.model.shared_attn:
            return "shared_attn"
        for i, b in enumerate(self.model.blocks):
            if b is block:
                return f"blocks.{i}"
        raise ValueError("not a block of this model")


def resident_bytes(tree) -> int:
    """Bytes of every tensor of a tree (nested dicts, list leaves)."""
    total = 0
    for leaf in _tensor_leaves(tree):
        total += leaf.numel() * leaf.element_size()
    return total


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)
    else:
        yield tree


def shard_tree(full_tree, shardings, coord) -> dict:
    """This position's block of every leaf of a tree of whole tensors
    (stage leaves as lists are cut layer by layer)."""
    def one(t, s):
        if isinstance(t, (list, tuple)):
            sl = s.slices((len(t),) + tuple(t[0].shape), coord)[1:]
            return [x[sl].clone() for x in t]
        return t[s.slices(t.shape, coord)].clone()
    return _map2(one, full_tree, shardings)


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def zeros_like_tree(abstract, shardings, device) -> dict:
    """Zero blocks of every leaf of an abstract tree under ``shardings``."""
    return _map2(lambda a, s: torch.zeros(s.shard_shape(a.shape), dtype=a.dtype, device=device),
                 abstract, shardings)

