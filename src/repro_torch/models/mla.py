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

Every cast is the reference's.  On a mesh the heads split over ``model``
(``wq``/``wq_b``, ``wk_b``, ``wv_b`` and a row-split ``wo``, between f and
g) while the latents are computed whole on every rank; the latent cache
rests split along its sequence where ``model`` divides it, and the
absorbed step merges its softmax partials over ``model`` as GQA's
(:mod:`repro_torch.models.decode`).  Where ``model`` does not divide the
heads (the q-sequence case) the expanded prefill enters through f and
``layers.sdpa`` computes each rank's query rows against the whole
expanded K/V, gathered before a whole ``wo``; the absorbed step's one row
stays whole.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.models import decode as dec
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig, PSpec

C_AXES = ("batch", "cache_seq", "kv_lora")
R_AXES = ("batch", "cache_seq", None)


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
        "c_kv": PSpec((batch, seq, cfg.kv_lora_rank), C_AXES, init="zeros"),
        "k_rope": PSpec((batch, seq, cfg.qk_rope_dim), R_AXES, init="zeros"),
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
    return sh.constrain(c_kv, ("batch", "seq", "kv_lora")), k_rope


def _roped_q(x, p, cfg: ModelConfig, positions):
    """(q_nope, q_rope), the second rotated."""
    nope = cfg.qk_nope_dim
    q = _q_proj(x, p, cfg)
    angles = layers.rope_angles(positions, cfg.qk_rope_dim, cfg.rope_theta)
    return q[..., :nope], layers.apply_rope(q[..., nope:], angles)


def _split(p, cfg: ModelConfig):
    """The mesh where this rank holds a block of the heads, else None."""
    return layers.model_axis()[0] if p["wk_b"].shape[1] != cfg.n_heads else None


def mla_attention(x, p, cfg: ModelConfig, positions):
    """Prefill and forward attention (expanded heads).

    Returns (out (B, S, d), (c_kv, k_rope)) for the cache."""
    cd = cfg.dtype("compute")
    h = cfg.n_heads
    mesh = _split(p, cfg)
    cp = layers.cp_split(h, h)
    if mesh is not None or cp is not None:
        x = collectives.tp_copy(x, cp[0] if mesh is None else mesh)
    q_nope, q_rope = _roped_q(x, p, cfg, positions)
    c_kv, k_rope = _kv_latent(x, p, cfg, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["wk_b"].to(cd))
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["wv_b"].to(cd))
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        k_nope.shape[:-1] + (cfg.qk_rope_dim,))], dim=-1)
    heads = {"heads": h}
    qf = sh.constrain(qf, ("batch", "seq", "heads", "head_dim"), heads)
    kf = sh.constrain(kf, ("batch", "seq", "heads", "head_dim"), heads)
    o = layers.sdpa(qf, kf, v, cfg, causal=cfg.causal, n_kv=h)
    o = sh.constrain(o, ("batch", "seq", "heads", "head_dim"), heads)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(cd))
    if mesh is not None:
        out = collectives.tp_reduce(out, mesh)
    return sh.constrain(out, ("batch", "seq", "embed")), (c_kv, k_rope)


def prefill_cache(c_kv, k_rope, cfg: ModelConfig, seq_cap: int) -> dict:
    """A layer's cache of capacity ``seq_cap`` from the prefill's latents:
    on a mesh this rank's block of positions."""
    return {"c_kv": dec.seq_block(c_kv, seq_cap, C_AXES, {}),
            "k_rope": dec.seq_block(k_rope, seq_cap, R_AXES, {})}


def mla_decode(x, p, cfg: ModelConfig, cache: dict, pos: int, seq_cap: int | None = None):
    """The absorbed one-token step against the cache, which it updates in
    place at ``pos``.

    x: (B, 1, d); cache: {"c_kv": (B, S, kv_lora), "k_rope": (B, S, rope)},
    this rank's block on a mesh (``seq_cap`` the whole length, the cache's
    own by default).  Returns (out (B, 1, d), cache)."""
    cd = cfg.dtype("compute")
    b, h = x.shape[0], cfg.n_heads
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    seq_cap = c_kv.shape[1] if seq_cap is None else seq_cap
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    mesh = _split(p, cfg)
    if mesh is not None:
        x = collectives.tp_copy(x, mesh)
    q_nope, q_rope = _roped_q(x, p, cfg, positions)       # (B,1,H,nope), (B,1,H,rope)

    c_new, kr_new = _kv_latent(x, p, cfg, positions)
    split = dec.seq_split(b, seq_cap, (cfg.kv_lora_rank,), C_AXES)
    lo = split[2] * c_kv.shape[1] if split else 0
    if lo <= pos < lo + c_kv.shape[1]:
        c_kv[:, pos - lo:pos - lo + 1] = c_new.to(c_kv.dtype)
        k_rope[:, pos - lo:pos - lo + 1] = kr_new.to(k_rope.dtype)
    c_kv = sh.constrain(c_kv, C_AXES, {"cache_seq": seq_cap})
    k_rope = sh.constrain(k_rope, R_AXES, {"cache_seq": seq_cap})

    # wk_b absorbed into the query: scores in the latent space
    q_c = torch.einsum("bqhn,rhn->bqhr", q_nope, p["wk_b"].to(cd))
    if split and mesh is not None:
        q_c, q_rope = dec.gather_heads([q_c, q_rope], mesh)
    s_latent = torch.einsum("bqhr,bsr->bhqs", q_c, c_kv.to(cd))
    s_rope = torch.einsum("bqhn,bsn->bhqs", q_rope, k_rope.to(cd))
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    scores = (s_latent + s_rope).float() * scale
    mask = torch.arange(lo, lo + c_kv.shape[1], device=x.device) <= pos
    scores = torch.where(mask, scores, -1e30)
    if split:
        m, l, e, cf = dec.softmax_partials(scores, c_kv)
        ctx_c = torch.einsum("bhqs,bsr->bhqr", e, cf)
        ctx_c = collectives.merge_partials(m, l, ctx_c, split[0], ("model",))
        ctx_c = ctx_c.to(cd).transpose(1, 2)
        if mesh is not None:
            per = p["wk_b"].shape[1]
            ctx_c = ctx_c[:, :, split[2] * per:(split[2] + 1) * per]
    else:
        probs = torch.softmax(scores, dim=-1).to(cd)
        ctx_c = torch.einsum("bhqs,bsr->bqhr", probs, c_kv.to(cd))
    # wv_b absorbed on the way out
    ctx_v = torch.einsum("bqhr,rhk->bqhk", ctx_c, p["wv_b"].to(cd))
    out = torch.einsum("bqhk,hkd->bqd", ctx_v, p["wo"].to(cd))
    if mesh is not None:
        out = collectives.tp_reduce(out, mesh)
    return sh.constrain(out, ("batch", "seq", "embed")), cache
