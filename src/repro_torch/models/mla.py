"""Multi-head Latent Attention, DeepSeek-V2/V3 (port of ``repro.models.mla``).

Queries and keys/values are projected through low-rank latents; a layer's
decode cache holds only the compressed KV latent (``kv_lora`` wide) and the
shared roped key (``qk_rope`` wide), ``{"c_kv", "k_rope"}``.  Two paths:

* prefill and forward (:func:`mla_attention`): expand ``k_nope`` and ``v``
  from the latent and run the port's ``layers.sdpa`` over heads of
  ``qk_nope + qk_rope`` (q, k) and ``v_head_dim`` (v);
* decode (:func:`mla_decode`): the **absorbed** step, ``wk_b`` folded into
  the query and ``wv_b`` into the output, so the scores are taken in the
  latent space against the compressed cache, which it updates in place.

Every cast is the reference's; its sharding constraints have no
counterpart on one device.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig, PSpec


def mla_defs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    vh, kvl, ql = cfg.v_head_dim, cfg.kv_lora_rank, cfg.q_lora_rank
    defs = {
        "wkv_a": PSpec((d, kvl + rope), ("embed", "kv_lora")),
        "kv_norm": PSpec((kvl,), ("kv_lora",), init="ones"),
        "wk_b": PSpec((kvl, h, nope), ("kv_lora", "heads", "head_dim")),
        "wv_b": PSpec((kvl, h, vh), ("kv_lora", "heads", "head_dim")),
        "wo": PSpec((h, vh, d), ("heads", "head_dim", "embed")),
    }
    if ql:
        defs["wq_a"] = PSpec((d, ql), ("embed", "q_lora"))
        defs["q_norm"] = PSpec((ql,), ("q_lora",), init="ones")
        defs["wq_b"] = PSpec((ql, h, nope + rope), ("q_lora", "heads", "head_dim"))
    else:
        defs["wq"] = PSpec((d, h, nope + rope), ("embed", "heads", "head_dim"))
    return defs


def mla_cache_defs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """One layer's cache: the normalised latent and the roped shared key."""
    return {
        "c_kv": PSpec((batch, seq, cfg.kv_lora_rank), ("batch", "cache_seq", "kv_lora"),
                      init="zeros"),
        "k_rope": PSpec((batch, seq, cfg.qk_rope_dim), ("batch", "cache_seq", None),
                        init="zeros"),
    }


def _q_proj(x, p, cfg: ModelConfig):
    """Queries (B, S, H, nope + rope), through the q latent where there is one."""
    cd = cfg.dtype("compute")
    if cfg.q_lora_rank:
        cq = torch.matmul(x, p["wq_a"].to(cd))
        cq = layers.rmsnorm(cq, {"scale": p["q_norm"]}, cfg.norm_eps)
        return torch.einsum("bsr,rhk->bshk", cq, p["wq_b"].to(cd))
    return torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cd))


def _kv_latent(x, p, cfg: ModelConfig, positions):
    """The normalised latent (B, S, kv_lora) and the roped shared key
    (B, S, rope)."""
    kv_a = torch.matmul(x, p["wkv_a"].to(cfg.dtype("compute")))
    c_kv, k_rope = kv_a[..., :cfg.kv_lora_rank], kv_a[..., cfg.kv_lora_rank:]
    c_kv = layers.rmsnorm(c_kv, {"scale": p["kv_norm"]}, cfg.norm_eps)
    angles = layers.rope_angles(positions, cfg.qk_rope_dim, cfg.rope_theta)
    k_rope = layers.apply_rope(k_rope[:, :, None, :], angles)[:, :, 0, :]
    return c_kv, k_rope


def _roped_q(x, p, cfg: ModelConfig, positions):
    """(q_nope, q_rope), the second rotated."""
    nope = cfg.qk_nope_dim
    q = _q_proj(x, p, cfg)
    angles = layers.rope_angles(positions, cfg.qk_rope_dim, cfg.rope_theta)
    return q[..., :nope], layers.apply_rope(q[..., nope:], angles)


def mla_attention(x, p, cfg: ModelConfig, positions):
    """Prefill and forward attention (expanded heads).

    Returns (out (B, S, d), (c_kv, k_rope)) for the cache."""
    cd = cfg.dtype("compute")
    q_nope, q_rope = _roped_q(x, p, cfg, positions)
    c_kv, k_rope = _kv_latent(x, p, cfg, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["wk_b"].to(cd))
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["wv_b"].to(cd))
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        k_nope.shape[:-1] + (cfg.qk_rope_dim,))], dim=-1)
    o = layers.sdpa(qf, kf, v, cfg, causal=cfg.causal)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(cd)), (c_kv, k_rope)


def mla_decode(x, p, cfg: ModelConfig, cache: dict, pos: int):
    """The absorbed one-token step against the cache, which it updates in
    place at ``pos``.

    x: (B, 1, d); cache: {"c_kv": (B, S, kv_lora), "k_rope": (B, S, rope)}.
    Returns (out (B, 1, d), cache)."""
    cd = cfg.dtype("compute")
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _roped_q(x, p, cfg, positions)           # (B,1,H,nope), (B,1,H,rope)

    c_new, kr_new = _kv_latent(x, p, cfg, positions)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    c_kv[:, pos:pos + 1] = c_new.to(c_kv.dtype)
    k_rope[:, pos:pos + 1] = kr_new.to(k_rope.dtype)

    # wk_b absorbed into the query: scores in the latent space
    q_c = torch.einsum("bqhn,rhn->bqhr", q_nope, p["wk_b"].to(cd))
    s_latent = torch.einsum("bqhr,bsr->bhqs", q_c, c_kv.to(cd))
    s_rope = torch.einsum("bqhn,bsn->bhqs", q_rope, k_rope.to(cd))
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    scores = (s_latent + s_rope).float() * scale
    mask = torch.arange(c_kv.shape[1], device=x.device) <= pos
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(cd)
    ctx_c = torch.einsum("bhqs,bsr->bqhr", probs, c_kv.to(cd))
    # wv_b absorbed on the way out
    ctx_v = torch.einsum("bqhr,rhk->bqhk", ctx_c, p["wv_b"].to(cd))
    return torch.einsum("bqhk,hkd->bqd", ctx_v, p["wo"].to(cd)), cache
