"""Mixture-of-Experts feed-forward, DeepSeek-style (port of
``repro.models.moe``), with expert parallelism.

Routing is an f32 softmax, top-k and renormalisation; shared experts are a
dense gated MLP added beside the routed ones.  Dispatch is the reference's
index-based capacity scheme: a stable sort of the (token, expert) pairs by
expert, each pair's rank within its expert, the pairs past the capacity
``max(8, round_up_8(ceil(T * k * capacity_factor / E)))`` dropped (the
overflow slot), an (E, C, d) buffer, three batched expert products, and the
weighted combine.  Prompts above ``MOE_CHUNK`` tokens route chunk by chunk
with a zero-padded last chunk, as the reference's scan does.

The combine adds each token's k contributions in ascending expert order,
the order of the reference's ``segment_sum``, one add after another in the
compute dtype: no scatter-add, whose float atomics on CUDA would make two
runs differ in their bits.

Expert parallelism is the reference's ``shard_map`` island, written out:
under a mesh (:func:`repro_torch.distributed.sharding.logical_sharding`, or
``mesh=``) whose ``model`` axis has more than one rank and divides the
experts, each rank holds E/ep experts; the tokens, replicated over
``model``, are cut into ep slices and each rank routes its own (capacity
from the slice's token count), one all-to-all moves the (E, C, d) buffer to
(E/ep, ep*C, d) rows of its experts from every slice, the experts run, the
reverse all-to-all brings the rows back, and after the combine a gather
over ``model`` restores every token (:mod:`repro_torch.distributed.collectives`,
with autograd backwards).  The island's input is the same on every
``model`` rank (the residual stream after g); the shared experts are a
tensor-parallel MLP over ``shared_mlp`` beside it.  Each rank's combine keeps the ascending-expert
order.  :data:`DROPS`, when a list, collects each dispatch's dropped pairs.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed import sharding
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig, PSpec

MOE_CHUNK = 4096   # tokens per dispatch chunk

# a list to collect each dispatch's dropped (token, expert) pairs, or None
DROPS: list | None = None


def moe_defs(cfg: ModelConfig) -> dict:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    defs = {
        "router": PSpec((d, e), ("embed", "experts"), scale=0.02),
        "wg": PSpec((e, d, ff), ("experts", "embed", "expert_mlp")),
        "wu": PSpec((e, d, ff), ("experts", "embed", "expert_mlp")),
        "wd": PSpec((e, ff, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        defs["shared"] = layers.mlp_defs(cfg, d_ff=cfg.n_shared_experts * cfg.moe_d_ff,
                                         mlp_axis="shared_mlp")
    return defs


def _route(x_flat, router_w, cfg: ModelConfig):
    """softmax -> top-k -> renormalise, in f32. x_flat: (T, d).

    Returns (weights (T, k) in ``x_flat``'s dtype, expert ids (T, k))."""
    logits = torch.matmul(x_flat.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, cfg.top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-9)
    return weights.to(x_flat.dtype), idx


def capacity(t: int, cfg: ModelConfig) -> int:
    """Rows per expert for ``t`` tokens, rounded up to 8 (at least 8)."""
    cap = int(math.ceil(t * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, -(-cap // 8) * 8)


def dispatch_plan(idx, cfg: ModelConfig):
    """Where each (token, choice) pair of ``idx`` (T, k) goes.

    Returns (cap, order, slot, keep): ``order`` sorts the flattened pairs by
    expert, stably (token order within an expert); ``slot`` (T*k,), in that
    order, is the pair's row ``expert * cap + rank`` of the dispatch buffer,
    or the overflow row ``E * cap`` where the rank reaches ``cap``;
    ``keep`` marks the pairs that fit."""
    t, k = idx.shape
    e = cfg.n_experts
    cap = capacity(t, cfg)
    e_flat = idx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sort = e_flat[order]
    counts = torch.bincount(e_flat, minlength=e)
    starts = torch.cumsum(counts, dim=0) - counts
    pos = torch.arange(t * k, device=idx.device) - starts[e_sort]   # rank within expert
    keep = pos < cap
    slot = torch.where(keep, e_sort * cap + pos, e * cap)
    return cap, order, slot, keep


def _dispatch_compute_combine(x_flat, weights, idx, wg, wu, wd, cfg: ModelConfig,
                              mesh=None, ep: int = 1):
    """Capacity dispatch -> (all-to-all over ``model``) -> expert FFN ->
    (the reverse all-to-all) -> combine. x_flat: (T, d) local tokens;
    wg/wu/wd: the local experts (E/ep of them). Returns (T, d)."""
    t, d = x_flat.shape
    e, k = cfg.n_experts, cfg.top_k
    cd = cfg.dtype("compute")
    cap, order, slot, keep = dispatch_plan(idx, cfg)
    if DROPS is not None:
        DROPS.append(int((~keep).sum()))
    tok_sort = order // k                                   # tok_flat = repeat(arange(t), k)

    buf = torch.zeros((e * cap + 1, d), dtype=x_flat.dtype, device=x_flat.device)
    buf[slot] = x_flat[tok_sort]        # distinct rows but the overflow one, dropped next
    buf = buf[:-1].reshape(e, cap, d)
    if ep > 1:
        # (E, C, d) -> (E/ep, ep*C, d): my experts' rows from every slice
        buf = collectives.all_to_all(buf.reshape(ep, e // ep, cap, d), mesh, ("model",))
        buf = buf.transpose(0, 1).reshape(e // ep, ep * cap, d)

    g = torch.bmm(buf, wg.to(cd))
    u = torch.bmm(buf, wu.to(cd))
    y = torch.bmm(layers._silu(g) * u, wd.to(cd))
    if ep > 1:
        # reverse: (E/ep, ep*C, d) -> (E, C, d)
        y = y.reshape(e // ep, ep, cap, d).transpose(0, 1).contiguous()
        y = collectives.all_to_all(y, mesh, ("model",))
    y = y.reshape(e * cap, d)

    # each pair's row, back in (token, choice) order, then each token's
    # choices in ascending expert order
    slot_tk = torch.empty_like(slot)
    slot_tk[order] = slot
    keep_tk = torch.empty_like(keep)
    keep_tk[order] = keep
    y_tok = torch.where(keep_tk[:, None], y[slot_tk.clamp(max=e * cap - 1)], 0.0)
    y_tok = (y_tok * weights.reshape(-1, 1).to(y_tok.dtype)).reshape(t, k, d)
    y_tok = torch.take_along_dim(y_tok, torch.argsort(idx, dim=-1)[..., None], dim=1)
    out = y_tok[:, 0]
    for j in range(1, k):
        out = out + y_tok[:, j]
    return out.to(x_flat.dtype)


def _moe_tokens(x_flat, router_w, wg, wu, wd, cfg: ModelConfig, mesh=None, ep: int = 1):
    """Routed experts over a flat (T, d) token slice, in chunks of MOE_CHUNK."""
    t, d = x_flat.shape
    if t <= MOE_CHUNK:
        w, idx = _route(x_flat, router_w, cfg)
        return _dispatch_compute_combine(x_flat, w, idx, wg, wu, wd, cfg, mesh, ep)
    n_chunks = -(-t // MOE_CHUNK)
    xp = torch.nn.functional.pad(x_flat, (0, 0, 0, n_chunks * MOE_CHUNK - t))
    out = []
    for xi in xp.reshape(n_chunks, MOE_CHUNK, d):
        w, idx = _route(xi, router_w, cfg)
        out.append(_dispatch_compute_combine(xi, w, idx, wg, wu, wd, cfg, mesh, ep))
    return torch.cat(out)[:t]


def _moe_local(x, router_w, wg, wu, wd, cfg: ModelConfig, mesh=None, ep: int = 1):
    """Routed experts of a (B, S, d) activation.  Under expert parallelism
    (``ep`` > 1) ``x`` is replicated over ``model``: each rank takes a
    disjoint 1/ep slice of the tokens (zero-padded to a multiple of ep),
    and a gather over ``model`` restores the replicated layout."""
    b, s, d = x.shape
    t = b * s
    x_flat = x.reshape(t, d)
    if ep == 1:
        return _moe_tokens(x_flat, router_w, wg, wu, wd, cfg).reshape(b, s, d)
    t_pad = -(-t // ep) * ep
    if t_pad != t:
        x_flat = torch.nn.functional.pad(x_flat, (0, 0, 0, t_pad - t))
    x_m = collectives.slice_along(x_flat, mesh, ("model",))
    y_m = _moe_tokens(x_m, router_w, wg, wu, wd, cfg, mesh, ep)
    y = collectives.gather_along(y_m, mesh, ("model",))
    return y[:t].reshape(b, s, d)


def expert_parallel_degree(cfg: ModelConfig, mesh) -> int:
    """The reference's rule: a ``model`` axis of more than one rank that
    divides the experts shards them; 1 where there is none."""
    if mesh is None or not cfg.n_experts:
        return 1
    m = sharding.mesh_axes(mesh).get("model", 1)
    return m if m > 1 and cfg.n_experts % m == 0 else 1


def is_moe_layer(cfg: ModelConfig, i: int) -> bool:
    """Whether layer ``i`` of the model holds a MoE feed-forward (the moe
    family's layers after its first dense ones)."""
    return cfg.family == "moe" and i >= cfg.first_dense_layers


def ep_role(cfg: ModelConfig, mesh, name: str) -> str | None:
    """Expert parallelism's placement rule for the parameter leaf ``name``
    (dotted, as ``Model.named_parameters`` gives it).  ``"local"`` for a
    routed expert's weight (``blocks.<i>.ffn.wg|wu|wd``): each rank keeps
    its E/ep experts and never gathers them over ``model``.  ``"router"``
    for the router: each ``model`` rank routes its own token slice, so its
    gradient also sums over ``model``.  None for every other leaf, and for
    every leaf without expert parallelism."""
    parts = name.split(".")
    if (len(parts) != 4 or parts[0] != "blocks" or parts[2] != "ffn"
            or not is_moe_layer(cfg, int(parts[1]))
            or expert_parallel_degree(cfg, mesh) == 1):
        return None
    return {"wg": "local", "wu": "local", "wd": "local", "router": "router"}.get(parts[3])


def moe_ffn(x, params, cfg: ModelConfig, mesh=None):
    """Routed experts (+ shared experts) for a (B, S, d) activation.

    ``mesh`` (a ``DeviceMesh``; the :func:`~repro_torch.distributed.sharding.logical_sharding`
    mesh by default) with a ``model`` axis of more than one rank that
    divides the experts takes the expert-parallel island.  There the routed
    experts are this rank's E/ep (or all E, of which it takes its own), and
    the shared experts this rank's block of their width (or all of it, of
    which it takes its own) where ``shared_mlp`` splits over ``model``."""
    mesh = mesh if mesh is not None else sharding.current_mesh()
    ep = expert_parallel_degree(cfg, mesh)
    wg, wu, wd = params["wg"], params["wu"], params["wd"]
    if ep > 1 and wg.shape[0] == cfg.n_experts:
        m = collectives.axis_index(mesh, ("model",))
        per = cfg.n_experts // ep
        wg, wu, wd = (w[m * per:(m + 1) * per] for w in (wg, wu, wd))
    with sharding.no_constraints():
        out = _moe_local(x, params["router"], wg, wu, wd, cfg, mesh, ep)
    if cfg.n_shared_experts:
        width = cfg.n_shared_experts * cfg.moe_d_ff
        shared = params["shared"]
        ways = sharding.tp_ways(mesh, sharding.current_rules(), "shared_mlp", width)
        if ways > 1 and mesh is sharding.current_mesh() and shared["wg"].shape[1] == width:
            # whole weights under the mesh: this rank's block of the width
            r, per = collectives.axis_index(mesh, ("model",)), width // ways
            cols = slice(r * per, (r + 1) * per)
            shared = {"wg": shared["wg"][:, cols], "wu": shared["wu"][:, cols],
                      "wd": shared["wd"][cols]}
        out = out + layers.mlp(x, shared, cfg, d_ff=width)
    return sharding.constrain(out, ("batch", "seq", "embed"))
