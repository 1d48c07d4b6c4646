"""KV caches and one-token GQA attention (port of ``repro.models.decode``).

A layer's cache is ``{"k", "v"}``, each (B, seq_cap, KV, hd) in the
compute dtype.  All sequences of a decode batch sit at one position ``pos``
(the server aligns them, as the reference's does).  The reference
updates its cache functionally; here ``gqa_decode`` writes the new row in
place and returns the same dict, so a cache is owned by one generation
(``Server.generate`` builds a fresh one from each prefill).
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig, PSpec


def gqa_cache_defs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": PSpec((batch, seq, kv, hd), ("batch", "cache_seq", "kv_heads", "head_dim"),
                   init="zeros"),
        "v": PSpec((batch, seq, kv, hd), ("batch", "cache_seq", "kv_heads", "head_dim"),
                   init="zeros"),
    }


def gqa_decode(x, p, cfg: ModelConfig, cache: dict, pos: int):
    """One-token GQA attention against the cache, which it updates in place.

    x: (B, 1, d); cache: {"k","v"}: (B, S, KV, hd); pos: the new token's
    position.  Returns (out (B, 1, d), cache).
    """
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = layers.qkv_proj(x, p, cfg, positions)

    k, v = cache["k"], cache["v"]
    k[:, pos:pos + 1] = k_new.to(k.dtype)
    v[:, pos:pos + 1] = v_new.to(v.dtype)

    h, kv_heads, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv_heads
    qg = q.reshape(b, 1, kv_heads, g, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhgd,bshd->bhgqs", qg, k.to(q.dtype))
    scores = scores.float() * scale
    mask = torch.arange(k.shape[1], device=x.device) <= pos
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bhgqs,bshd->bqhgd", probs, v.to(q.dtype))
    out = layers.attn_out(o.reshape(b, 1, h, hd), p, cfg)
    return out, cache


def pad_seq(t, seq_cap: int):
    """``t`` (B, S, ...) zero-padded along its sequence axis to ``seq_cap``."""
    if seq_cap <= t.shape[1]:
        return t
    return torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, seq_cap - t.shape[1]))


def prefill_kv(k, v, seq_cap: int) -> dict:
    """A cache of capacity ``seq_cap`` holding the prefill's K/V."""
    return {"k": pad_seq(k, seq_cap), "v": pad_seq(v, seq_cap)}
