"""KV caches and one-token GQA attention (port of ``repro.models.decode``).

A layer's cache is ``{"k", "v"}``, each (B, seq_cap, KV, hd) in the
compute dtype.  All sequences of a decode batch sit at one position ``pos``
(the server aligns them, as the reference's does).  The reference
updates its cache functionally; here ``gqa_decode`` writes the new row in
place and returns the same dict, so a cache is owned by one generation
(``Server.generate`` builds a fresh one from each prefill).

On a mesh the cache rests as its spec gives this rank
(``("batch", "cache_seq", "kv_heads", "head_dim")`` under the reference's
rules): where ``model`` divides ``seq_cap`` the sequence is split over it
(flash-decoding) and every rank holds all KV heads of its block of
positions.  :func:`prefill_kv` reshards the prefill's head-split K/V into
those blocks (one all-to-all).  :func:`gqa_decode` gathers q (and new K/V
rows that are split by head) over ``model``; the rank that owns ``pos``
writes it; each rank takes the softmax partials (row max, sum, unnormalised
output) over its block under the same -1e30 mask, and
:func:`~repro_torch.distributed.collectives.merge_partials` merges them in
rank order.  Each rank then keeps its heads for the row-split ``wo``.
Where ``model`` does not divide ``seq_cap`` the sequence stays whole, and
the cache is split by KV head where they divide ``model`` (each rank
attends its own heads) or whole.  In the q-sequence case a decode step's
one query row does not split over ``model`` (the reference's
divisibility fallback): every rank attends every head, of its block of
positions where the cache is split.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig, PSpec

CACHE_AXES = ("batch", "cache_seq", "kv_heads", "head_dim")


def gqa_cache_defs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": PSpec((batch, seq, kv, hd), CACHE_AXES, init="zeros"),
        "v": PSpec((batch, seq, kv, hd), CACHE_AXES, init="zeros"),
    }


def seq_split(rows: int, seq_cap: int, rest: tuple, axes: tuple):
    """(mesh, m, this rank's index) where a cache of ``rows`` local rows
    and ``seq_cap`` positions (then ``rest``, under logical ``axes``) rests
    split along its sequence over ``model``; None where it is whole."""
    mesh = sh.current_mesh()
    if mesh is None:
        return None
    rules = sh.current_rules()
    spec = sh.logical_to_spec((sh.global_rows(rows, mesh, rules), seq_cap) + tuple(rest),
                              axes, mesh, rules)
    if len(spec) > 1 and "model" in sh.spec_axes(spec[1]):
        return layers.model_axis()
    return None


def gather_heads(ts, mesh) -> list:
    """Each tensor of ``ts`` (B, S, this rank's heads, ...) whole along its
    heads: one all-gather over ``model`` of them all."""
    b, s = ts[0].shape[:2]
    sizes = [t[0, 0].numel() for t in ts]
    parts = [p.split(sizes, dim=2) for p in collectives.all_gather_axes(
        torch.cat([t.reshape(b, s, -1) for t in ts], dim=2), mesh, ("model",))]
    return [torch.cat([p[i].reshape(t.shape) for p in parts], dim=2)
            for i, t in enumerate(ts)]


def softmax_partials(scores, v):
    """Flash-decoding's partials of f32 ``scores`` (..., S) against ``v``:
    (row max, sum of exponentials, unnormalised output), f32."""
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    return m, p.sum(dim=-1, keepdim=True), p, v.float()


def gqa_decode(x, p, cfg: ModelConfig, cache: dict, pos: int, seq_cap: int | None = None):
    """One-token GQA attention against the cache, which it updates in place.

    x: (B, 1, d); cache: {"k","v"}: (B, S, KV, hd), this rank's block on a
    mesh; pos: the new token's position; ``seq_cap``: the whole cache's
    length (the cache's own on one device).  Returns (out (B, 1, d), cache).
    """
    b = x.shape[0]
    h, kv_heads, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    k, v = cache["k"], cache["v"]
    seq_cap = k.shape[1] if seq_cap is None else seq_cap
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = layers.qkv_proj(x, p, cfg, positions)
    split = seq_split(b, seq_cap, (kv_heads, hd), CACHE_AXES)
    local_heads = q.shape[2] != h
    mesh = layers.model_axis()[0] if (split or local_heads) else None
    if split or (local_heads and k.shape[2] == kv_heads):
        # every head against this rank's block of positions (or, with
        # the q group split, against the whole cache)
        if k_new.shape[2] != kv_heads:
            q, k_new, v_new = gather_heads([q, k_new, v_new], mesh)
        elif local_heads:
            (q,) = gather_heads([q], mesh)
    lo = split[2] * k.shape[1] if split else 0
    if lo <= pos < lo + k.shape[1]:
        k[:, pos - lo:pos - lo + 1] = k_new.to(k.dtype)
        v[:, pos - lo:pos - lo + 1] = v_new.to(v.dtype)
    k = sh.constrain(k, CACHE_AXES, {"cache_seq": seq_cap, "kv_heads": kv_heads})
    v = sh.constrain(v, CACHE_AXES, {"cache_seq": seq_cap, "kv_heads": kv_heads})

    n_q, kv = q.shape[2], k.shape[2]
    qg = q.reshape(b, 1, kv, n_q // kv, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhgd,bshd->bhgqs", qg, k.to(q.dtype))
    scores = scores.float() * scale
    mask = torch.arange(lo, lo + k.shape[1], device=x.device) <= pos
    scores = torch.where(mask, scores, -1e30)
    if split:
        m, l, e, vf = softmax_partials(scores, v)
        o = torch.einsum("bhgqs,bshd->bhgqd", e, vf)
        o = collectives.merge_partials(m, l, o, mesh, ("model",)).to(q.dtype)
        o = o.permute(0, 3, 1, 2, 4)
    else:
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        o = torch.einsum("bhgqs,bshd->bqhgd", probs, v.to(q.dtype))
    o = o.reshape(b, 1, n_q, hd)
    if local_heads and n_q == h:
        per = p["wo"].shape[0]
        r = layers.model_axis()[2]
        o = o[:, :, r * per:(r + 1) * per]
    out = layers.attn_out(o, p, cfg)
    return out, cache


def pad_seq(t, seq_cap: int):
    """``t`` (B, S, ...) zero-padded along its sequence axis to ``seq_cap``."""
    if seq_cap <= t.shape[1]:
        return t
    return torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, seq_cap - t.shape[1]))


def seq_block(t, seq_cap: int, axes: tuple, sizes: dict):
    """``t`` (B, S, ...), padded to ``seq_cap``, as its cache rests: this
    rank's block of positions where the sequence splits over ``model``."""
    t = pad_seq(t, seq_cap)
    split = seq_split(t.shape[0], seq_cap, tuple(sizes.get(a, n) for a, n in
                                                 zip(axes[2:], t.shape[2:])), axes)
    if split:
        per = seq_cap // split[1]
        t = t[:, split[2] * per:(split[2] + 1) * per].clone()
    return sh.constrain(t, axes, dict(sizes, cache_seq=seq_cap))


def prefill_kv(k, v, seq_cap: int, n_kv: int | None = None) -> dict:
    """A cache of capacity ``seq_cap`` holding the prefill's K/V (``n_kv``
    KV heads whole; the block's own by default): on a mesh this rank's
    block, head-split K/V resharded to sequence blocks by one all-to-all
    over ``model``."""
    n_kv = k.shape[2] if n_kv is None else n_kv
    sizes = {"kv_heads": n_kv}
    split = seq_split(k.shape[0], seq_cap, (n_kv, k.shape[3]), CACHE_AXES)
    if split and k.shape[2] != n_kv:
        mesh, m, _ = split
        b, _, kv_l, hd = k.shape
        per = seq_cap // m
        x = torch.stack([pad_seq(k, seq_cap), pad_seq(v, seq_cap)])
        x = x.reshape(2, b, m, per, kv_l, hd).permute(2, 0, 1, 3, 4, 5).contiguous()
        x = collectives.all_to_all_raw(x, mesh, ("model",))
        x = x.permute(1, 2, 3, 0, 4, 5).reshape(2, b, per, m * kv_l, hd)
        sizes["cache_seq"] = seq_cap
        return {"k": sh.constrain(x[0], CACHE_AXES, sizes),
                "v": sh.constrain(x[1], CACHE_AXES, sizes)}
    return {"k": seq_block(k, seq_cap, CACHE_AXES, sizes),
            "v": seq_block(v, seq_cap, CACHE_AXES, sizes)}
