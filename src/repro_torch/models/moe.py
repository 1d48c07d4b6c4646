"""Mixture-of-Experts feed-forward, DeepSeek-style (port of
``repro.models.moe``), on one device.

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

The expert-parallel path (the ``all_to_all`` dispatch inside a
``shard_map`` island) waits for ROADMAP queue 1, the LM stack's 'LM
multi-device path' part; :func:`moe_ffn` raises if handed an expert axis.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig, PSpec

MOE_CHUNK = 4096   # tokens per dispatch chunk

EXPERT_PARALLEL_LATER = ("expert parallelism (the all_to_all dispatch) comes with "
                         "ROADMAP queue 1, the LM stack's 'LM multi-device path' part")


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


def _dispatch_compute_combine(x_flat, weights, idx, wg, wu, wd, cfg: ModelConfig):
    """Capacity dispatch -> expert FFN -> combine. x_flat: (T, d). Returns (T, d)."""
    t, d = x_flat.shape
    e, k = cfg.n_experts, cfg.top_k
    cd = cfg.dtype("compute")
    cap, order, slot, keep = dispatch_plan(idx, cfg)
    tok_sort = order // k                                   # tok_flat = repeat(arange(t), k)

    buf = torch.zeros((e * cap + 1, d), dtype=x_flat.dtype, device=x_flat.device)
    buf[slot] = x_flat[tok_sort]        # distinct rows but the overflow one, dropped next
    buf = buf[:-1].reshape(e, cap, d)

    g = torch.bmm(buf, wg.to(cd))
    u = torch.bmm(buf, wu.to(cd))
    y = torch.bmm(layers._silu(g) * u, wd.to(cd)).reshape(e * cap, d)

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


def _moe_tokens(x_flat, router_w, wg, wu, wd, cfg: ModelConfig):
    """Routed experts over a flat (T, d) token slice, in chunks of MOE_CHUNK."""
    t, d = x_flat.shape
    if t <= MOE_CHUNK:
        w, idx = _route(x_flat, router_w, cfg)
        return _dispatch_compute_combine(x_flat, w, idx, wg, wu, wd, cfg)
    n_chunks = -(-t // MOE_CHUNK)
    xp = torch.nn.functional.pad(x_flat, (0, 0, 0, n_chunks * MOE_CHUNK - t))
    out = []
    for xi in xp.reshape(n_chunks, MOE_CHUNK, d):
        w, idx = _route(xi, router_w, cfg)
        out.append(_dispatch_compute_combine(xi, w, idx, wg, wu, wd, cfg))
    return torch.cat(out)[:t]


def _moe_local(x, router_w, wg, wu, wd, cfg: ModelConfig):
    """Routed experts of a (B, S, d) activation on one device."""
    b, s, d = x.shape
    return _moe_tokens(x.reshape(b * s, d), router_w, wg, wu, wd, cfg).reshape(b, s, d)


def moe_ffn(x, params, cfg: ModelConfig, mesh=None):
    """Routed experts (+ shared experts) for a (B, S, d) activation.

    ``mesh`` (a ``DeviceMesh``) with a ``model`` axis of more than one rank
    that divides the experts is the reference's expert-parallel case, which
    raises here."""
    if mesh is not None:
        names = tuple(mesh.mesh_dim_names or ())
        if "model" in names:
            m = mesh.size(names.index("model"))
            if m > 1 and cfg.n_experts % m == 0:
                raise NotImplementedError(EXPERT_PARALLEL_LATER)
    out = _moe_local(x, params["router"], params["wg"], params["wu"], params["wd"], cfg)
    if cfg.n_shared_experts:
        out = out + layers.mlp(x, params["shared"], cfg)
    return out
