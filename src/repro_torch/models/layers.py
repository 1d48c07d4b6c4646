"""Transformer layers as plain functions on tensors (port of
``repro.models.layers``): rmsnorm, the three RoPE styles, embedding and
output head, GQA attention and the gated MLP.

Parameters arrive as dicts (or ``nn.ParameterDict``s) in the reference's
layouts: ``wq (d, h, hd)``, ``wk``/``wv (d, kv, hd)``, ``wo (h, hd, d)``,
``wg``/``wu (d, ff)``, ``wd (ff, d)``, ``tok (vocab_padded, d)``,
``out (d, vocab_padded)``.  Every weight is cast to the compute dtype where
it is used, every score goes to f32 after the product in the compute dtype,
and the probabilities go back to ``q``'s dtype, cast for cast as the
reference does; a cast to the dtype a tensor already has is free.

Attention computes the full (q_len, kv_len) score rectangle and masks it
with -1e30, as the reference does (no ``scaled_dot_product_attention``,
whose arithmetic differs); above ``Q_CHUNK_THRESHOLD`` it walks query
blocks of ``Q_CHUNK`` against all keys.  The reference's sharding
constraints are kept at its call sites
(:func:`repro_torch.distributed.sharding.constrain`): on a mesh, weights
are gathered whole before use, so they check that an activation's batch
dim is this rank's block and return it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain, current_mesh, mesh_axes
from repro_torch.models.config import ModelConfig, PSpec

# q-chunking kicks in above this sequence length
Q_CHUNK_THRESHOLD = 8192
Q_CHUNK = 1024


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_defs(d: int) -> dict:
    return {"scale": PSpec((d,), ("embed",), init="ones")}


def rmsnorm(x, params, eps: float):
    """Statistics in f32, the normalising multiply in ``x.dtype``."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard / partial "2d" / M-RoPE)
# ---------------------------------------------------------------------------

def _inv_freq(n: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, n, dtype=np.float32) / n))


@functools.lru_cache(maxsize=64)
def _inv_freq_on(n: int, theta: float, device: torch.device) -> torch.Tensor:
    # the reference's numpy f32 frequencies, copied to the device once: a
    # copy from host memory at every layer would wait for the device there
    # (callers only read the tensor)
    return torch.from_numpy(_inv_freq(n, theta)).to(device)


def rope_angles(positions, rot_dim: int, theta: float, mrope_sections=None):
    """Angles (.., seq, rot_dim/2) in f32 for the given positions.

    positions: (B, S) integers, or (3, B, S) for M-RoPE (t/h/w components).
    """
    half = rot_dim // 2
    inv = _inv_freq_on(half, theta, positions.device)
    if mrope_sections is None:
        return positions[..., None].float() * inv            # (B, S, half)
    # M-RoPE: each section of the half-dim is driven by one position
    # component (temporal / height / width).
    if positions.ndim != 3 or positions.shape[0] != len(mrope_sections):
        raise ValueError(f"M-RoPE positions {tuple(positions.shape)} for "
                         f"{len(mrope_sections)} sections")
    parts = []
    start = 0
    for comp, sec in enumerate(mrope_sections):
        parts.append(positions[comp][..., None].float() * inv[start:start + sec])
        start += sec
    return torch.cat(parts, dim=-1)                          # (B, S, half)


def apply_rope(x, angles):
    """Rotate the first 2*angles.shape[-1] dims of the head vectors.

    x: (B, S, H, D); angles: (B, S, half) with 2*half <= D (partial rotary
    covers chatglm's '2d' RoPE, where only half the head dims rotate).
    """
    half = angles.shape[-1]
    rot, rest = x[..., : 2 * half], x[..., 2 * half:]
    x1, x2 = rot[..., :half], rot[..., half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.cat([r1, r2, rest], dim=-1)


def rope_for(cfg: ModelConfig, positions, head_dim: int | None = None):
    """Config-dispatched angles; None for rope_style == 'none'."""
    hd = head_dim if head_dim is not None else cfg.head_dim
    if cfg.rope_style == "none":
        return None
    if cfg.rope_style == "standard":
        return rope_angles(positions, hd, cfg.rope_theta)
    if cfg.rope_style == "2d":
        # chatglm: rotary on the first half of the head dims only
        return rope_angles(positions, hd // 2, cfg.rope_theta)
    if cfg.rope_style == "mrope":
        half = hd // 2
        # qwen2-vl sections (t, h, w) = (2/8, 3/8, 3/8) of the half dim
        sec_t = half // 4
        sec_h = (half - sec_t) // 2
        sections = [sec_t + (half - sec_t - 2 * sec_h), sec_h, sec_h]
        if positions.ndim == 2:      # text only: the same position for t/h/w
            positions = positions[None].expand((3,) + tuple(positions.shape))
        return rope_angles(positions, hd, cfg.rope_theta, mrope_sections=sections)
    raise ValueError(cfg.rope_style)


# ---------------------------------------------------------------------------
# Embeddings / output head
# ---------------------------------------------------------------------------

def embed_defs(cfg: ModelConfig) -> dict:
    d = {"tok": PSpec((cfg.vocab_padded, cfg.d_model), ("vocab", "embed"), scale=0.02)}
    if cfg.frontend_dim:
        d["frontend_proj"] = PSpec((cfg.frontend_dim, cfg.d_model), ("frontend", "embed"))
    return d


def embed(tokens, params, cfg: ModelConfig):
    return params["tok"][tokens].to(cfg.dtype("compute"))


def head_defs(cfg: ModelConfig) -> dict:
    if cfg.tie_embeddings:
        return {}
    return {"out": PSpec((cfg.d_model, cfg.vocab_padded), ("embed", "vocab"), scale=0.02)}


def lm_head(x, params, embed_params, cfg: ModelConfig):
    """Logits over the padded vocab; padding columns masked to -1e30."""
    cd = cfg.dtype("compute")
    w = embed_params["tok"].to(cd).T if cfg.tie_embeddings else params["out"].to(cd)
    logits = torch.matmul(x, w)
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return constrain(logits, ("batch", "seq", "vocab"))


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attn_defs(cfg: ModelConfig) -> dict:
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    defs = {
        "wq": PSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": PSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": PSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": PSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = PSpec((h, hd), ("heads", "head_dim"), init="zeros")
        defs["bk"] = PSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
        defs["bv"] = PSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
    return defs


def qkv_proj(x, params, cfg: ModelConfig, positions):
    """Project and rotate. Returns q (B,S,H,D), k/v (B,S,KV,D)."""
    cd = cfg.dtype("compute")
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(cd))
    if cfg.qkv_bias:
        q = q + params["bq"].to(cd)
        k = k + params["bk"].to(cd)
        v = v + params["bv"].to(cd)
    angles = rope_for(cfg, positions)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    q = constrain(q, ("batch", "seq", "heads", "head_dim"))
    k = constrain(k, ("batch", "seq", "kv_heads", "head_dim"))
    v = constrain(v, ("batch", "seq", "kv_heads", "head_dim"))
    return q, k, v


def _score_axes(n_kv_heads: int, group: int):
    """The reference's logical axes of the (B, KV, G, Sq, Sk) scores on the
    current mesh: KV heads over ``model`` where they divide it, else the
    GQA group (q-head parallelism), else the q sequence (context
    parallelism)."""
    mesh = current_mesh()
    sizes = mesh_axes(mesh) if mesh is not None else {}
    if "model" not in sizes:
        return ("batch", "kv_heads", "qgroup", None, None)
    m = sizes["model"]
    if n_kv_heads % m == 0:
        return ("batch", "kv_heads", "qgroup", None, None)
    if group % m == 0:
        return ("batch", None, "heads", None, None)
    return ("batch", None, "qgroup", "attn_q_seq", None)


def _sdpa_full(q, k, v, *, causal: bool, q_offset: int = 0):
    """Grouped scores over the whole (q_len, kv_len) rectangle.

    q: (B, Sq, KV, G, D); k/v: (B, Sk, KV, D). Returns (B, Sq, KV, G, D).
    """
    sq, d = q.shape[1], q.shape[-1]
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
    scores = constrain(scores, _score_axes(k.shape[2], q.shape[3]))
    if causal:
        qi = torch.arange(sq, device=q.device) + q_offset
        ki = torch.arange(sk, device=q.device)
        mask = qi[:, None] >= ki[None, :]
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return constrain(out, ("batch", None, None, "heads", None))


def sdpa(q, k, v, cfg: ModelConfig, *, causal: bool):
    """Full or q-chunked attention; GQA grouping handled here.

    q: (B, S, H, D) -> out (B, S, H, DV).  Query head h reads KV head
    h // (H // KV).
    """
    b, s, h, d = q.shape
    kv = k.shape[2]
    dv = v.shape[-1]
    g = h // kv
    qg = q.reshape(b, s, kv, g, d)
    threshold = min(Q_CHUNK_THRESHOLD, cfg.attn_q_chunk_threshold)
    if s <= threshold:
        return _sdpa_full(qg, k, v, causal=causal).reshape(b, s, h, dv)
    # q-chunked: a ragged last block is cut, as the reference's zero
    # padding of the query axis and slice after give the same rows
    blocks = [_sdpa_full(qg[:, i:i + Q_CHUNK], k, v, causal=causal, q_offset=i)
              for i in range(0, s, Q_CHUNK)]
    return torch.cat(blocks, dim=1).reshape(b, s, h, dv)


def attn_out(o, params, cfg: ModelConfig):
    o = constrain(o, ("batch", "seq", "heads", "head_dim"))
    out = torch.einsum("bshk,hkd->bsd", o, params["wo"].to(cfg.dtype("compute")))
    return constrain(out, ("batch", "seq", "embed"))


def attention(x, params, cfg: ModelConfig, positions):
    """Prefill and forward attention (causal unless encoder)."""
    q, k, v = qkv_proj(x, params, cfg, positions)
    o = sdpa(q, k, v, cfg, causal=cfg.causal and not cfg.is_encoder)
    return attn_out(o, params, cfg)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: int | None = None, mlp_axis: str = "mlp") -> dict:
    ff = d_ff if d_ff is not None else cfg.d_ff
    d = cfg.d_model
    return {
        "wg": PSpec((d, ff), ("embed", mlp_axis)),
        "wu": PSpec((d, ff), ("embed", mlp_axis)),
        "wd": PSpec((ff, d), (mlp_axis, "embed")),
    }


def _silu(x):
    # the reference's x * logistic(x), the logistic as 1 / (1 + exp(-x))
    # rounded to x.dtype at each step, as XLA evaluates it in bf16 (F.silu
    # rounds once, and differs from it in a quarter of bf16 outputs)
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": _silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def mlp(x, params, cfg: ModelConfig, act: str = "silu"):
    cd = cfg.dtype("compute")
    g = torch.matmul(x, params["wg"].to(cd))
    u = torch.matmul(x, params["wu"].to(cd))
    h = constrain(_act(act)(g) * u, ("batch", "seq", "mlp"))
    return constrain(torch.matmul(h, params["wd"].to(cd)), ("batch", "seq", "embed"))
