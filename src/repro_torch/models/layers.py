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
blocks of ``Q_CHUNK`` against all keys.

On a mesh each layer computes on the blocks it is given
(:mod:`repro_torch.distributed.fsdp`): Megatron's tensor parallelism over
``model``, as the reference's rules shard it.  q/k/v are column-split by
heads and ``wo`` row-split, the MLP's ``wg``/``wu`` column-split and
``wd`` row-split, the embedding and head split by vocab.  Each region
starts with :func:`~repro_torch.distributed.collectives.tp_copy` (f) and
ends in :func:`~repro_torch.distributed.collectives.tp_reduce` (g), a sum
over ``model`` folded in rank order.  A layer knows its split from its
weights' shapes against the config's whole counts.  Attention follows
:func:`_score_axes`' three cases (:func:`attn_mode`): KV heads split; K/V
whole with the q group split (the heads relaid out to the reference's (KV,
group) block and back); and the q sequence (context parallelism,
:func:`cp_split`), where each ``model`` rank computes the scores of its
block of the query rows against the whole K/V (:func:`cp_chunks`: a
contiguous S/m rows, or S/m rows of every ``Q_CHUNK`` block above the
threshold, as the reference's per-block constraint splits them; rows that
``model`` does not divide are zero-padded to a multiple of it).  There
the region starts with f, so that x's gradient through K/V, which comes
from this rank's rows only, folds over ``model``.  With the heads whole on
every rank (h % m != 0: every production case) the rows' outputs are
gathered along the sequence before ``wo``, as the reference's constraint on
the attention output places it, and ``wo`` runs whole; with the heads split
(h % m == 0) q is relaid out from head blocks to row blocks and the output
back, and ``wo`` stays row-split, ending in g.  The reference's sharding
constraints are kept at its call sites
(:func:`repro_torch.distributed.sharding.constrain`), where they check each
activation's block.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import constrain, current_mesh, mesh_axes
from repro_torch.models.config import ModelConfig, PSpec

# q-chunking kicks in above this sequence length
Q_CHUNK_THRESHOLD = 8192
Q_CHUNK = 1024


def model_axis():
    """(mesh, size, this rank's index) of the current mesh's ``model`` axis
    for a layer given split weights; raises without one."""
    mesh = current_mesh()
    m = mesh_axes(mesh).get("model", 1) if mesh is not None else 1
    if m == 1:
        raise ValueError("a layer got tensor-parallel weights outside a mesh with a "
                         "'model' axis")
    return mesh, m, collectives.axis_index(mesh, ("model",))


def attn_mode(mesh, rules, n_heads: int, n_kv: int) -> str | None:
    """How attention splits over ``model`` (:func:`_score_axes`' cases):
    ``"kv"`` (KV heads, and so q heads), ``"qgroup"`` (q heads by their
    group, K/V whole), the q sequence (context parallelism) with the heads
    whole on every rank, ``"qseq"``, or split over ``model``,
    ``"qseq_heads"``, or None (no ``model`` axis, or rules that do not
    split heads)."""
    m = mesh_axes(mesh).get("model", 1) if mesh is not None else 1
    if sh.tp_ways(mesh, rules, "heads", m) == 1:
        return None
    if sh.tp_ways(mesh, rules, "kv_heads", n_kv) > 1:
        return "kv"
    if (n_heads // n_kv) % m == 0:
        return "qgroup"
    if sh.tp_ways(mesh, rules, "attn_q_seq", m) == 1:
        return None
    return "qseq_heads" if sh.tp_ways(mesh, rules, "heads", n_heads) > 1 else "qseq"


def cp_split(n_heads: int, n_kv: int):
    """(mesh, m, this rank's index, whether the heads split) where attention
    of ``n_heads`` on ``n_kv`` KV heads is in the q-sequence case on the
    current mesh, else None."""
    mesh = current_mesh()
    mode = None if mesh is None else attn_mode(mesh, sh.current_rules(), n_heads, n_kv)
    if mode not in ("qseq", "qseq_heads"):
        return None
    return model_axis() + (mode == "qseq_heads",)


def cp_chunks(s: int, m: int, threshold: int) -> list[tuple[int, int]]:
    """The blocks of query rows that the q-sequence case splits over ``m``
    ranks, as (position of the first row, rows): the whole sequence up to
    ``threshold``, else each ``Q_CHUNK`` block.  A block that ``m`` does not
    divide (a sequence, a ragged last block, or every block where ``m`` does
    not divide ``Q_CHUNK``) is zero-padded to a multiple of ``m``, where the
    reference would leave its rows whole or pad a last block to ``Q_CHUNK``;
    the dummy rows sit after the block's own (:func:`cp_positions`) and are
    dropped after."""
    if s <= threshold:
        return [(0, -(-s // m) * m)]
    return [(i, -(-min(Q_CHUNK, s - i) // m) * m) for i in range(0, s, Q_CHUNK)]


def cp_positions(chunks: list[tuple[int, int]], s: int) -> list[int]:
    """The sequence position of each slot of the blocks laid end to end (a
    block's rows, then its dummy rows, whose position is -1)."""
    ends = [c0 for c0, _ in chunks[1:]] + [s]
    return [c0 + j if c0 + j < end else -1
            for (c0, n), end in zip(chunks, ends) for j in range(n)]


def cp_rows(chunks: list[tuple[int, int]], m: int, r: int) -> tuple[int, ...]:
    """Rank ``r``'s slots (:func:`cp_positions`): the r-th of ``m`` equal
    parts of each block."""
    out, at = [], 0
    for _, n in chunks:
        out += range(at + r * (n // m), at + (r + 1) * (n // m))
        at += n
    return tuple(out)


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
    """Token embeddings in the compute dtype.  A vocab-split table (this
    rank's rows) looks up the tokens it holds, zeros elsewhere, and the
    ranks' rows are summed over ``model`` (g: each token is one rank's)."""
    tok = params["tok"]
    cd = cfg.dtype("compute")
    if tok.shape[0] == cfg.vocab_padded:
        out = tok[tokens].to(cd)
    else:
        mesh, _, r = model_axis()
        n = tok.shape[0]
        local = tokens - r * n
        hit = (local >= 0) & (local < n)
        out = tok[local.clamp(0, n - 1)].to(cd).masked_fill(~hit[..., None], 0.0)
        out = collectives.tp_reduce(out, mesh)
    return constrain(out, ("batch", "seq", "embed"))


def head_defs(cfg: ModelConfig) -> dict:
    if cfg.tie_embeddings:
        return {}
    return {"out": PSpec((cfg.d_model, cfg.vocab_padded), ("embed", "vocab"), scale=0.02)}


def lm_head(x, params, embed_params, cfg: ModelConfig):
    """Logits over the padded vocab; padding columns masked to -1e30.  With
    a vocab-split head, this rank's columns (``x`` enters through f)."""
    cd = cfg.dtype("compute")
    w = embed_params["tok"].to(cd).T if cfg.tie_embeddings else params["out"].to(cd)
    lo = 0
    if w.shape[-1] != cfg.vocab_padded:
        mesh, _, r = model_axis()
        x = collectives.tp_copy(x, mesh)
        lo = r * w.shape[-1]
    logits = torch.matmul(x, w)
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(lo, lo + w.shape[-1], device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return constrain(logits, ("batch", "seq", "vocab"), {"vocab": cfg.vocab_padded})


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
    """Project and rotate. Returns q (B,S,H,D), k/v (B,S,KV,D): this rank's
    heads where the weights are split (``x`` enters through f, as it does
    in the q-sequence case)."""
    cd = cfg.dtype("compute")
    if params["wq"].shape[1] != cfg.n_heads:
        x = collectives.tp_copy(x, model_axis()[0])
    elif (cp := cp_split(cfg.n_heads, cfg.n_kv_heads)) is not None:
        x = collectives.tp_copy(x, cp[0])
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
    heads = {"heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads}
    q = constrain(q, ("batch", "seq", "heads", "head_dim"), heads)
    k = constrain(k, ("batch", "seq", "kv_heads", "head_dim"), heads)
    v = constrain(v, ("batch", "seq", "kv_heads", "head_dim"), heads)
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


def _sdpa_full(q, k, v, *, causal: bool, q_offset: int = 0, n_kv: int | None = None,
               group: int | None = None, q_rows: int | None = None):
    """Grouped scores over the whole (q_len, kv_len) rectangle.

    q: (B, Sq, KV, G, D); k/v: (B, Sk, KV, D). Returns (B, Sq, KV, G, D).
    ``n_kv`` and ``group`` are the whole counts (the block's own by
    default), ``q_rows`` the whole block's query rows of which ``q`` is
    this rank's part in the q-sequence case (``Sq`` by default): on a mesh
    the constraints check the blocks against them.  Query row i sits at
    position ``q_offset + i``.
    """
    sq, d = q.shape[1], q.shape[-1]
    sk = k.shape[1]
    n_kv = k.shape[2] if n_kv is None else n_kv
    group = q.shape[3] if group is None else group
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
    sizes = {"kv_heads": n_kv, "qgroup": group, "heads": group,
             "attn_q_seq": sq if q_rows is None else q_rows}
    scores = constrain(scores, _score_axes(n_kv, group), sizes)
    if causal:
        qi = torch.arange(sq, device=q.device) + q_offset
        ki = torch.arange(sk, device=q.device)
        mask = qi[:, None] >= ki[None, :]
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    if k.shape[2] == n_kv:
        # with the KV heads split the reference's constraint here gathers
        # the group's heads whole, for attention's next one to cut them
        # again; the port keeps its block
        out = constrain(out, ("batch", None, None, "heads", None), {"heads": group})
    return out


def cp_attend(q, k, v, *, causal: bool, chunks, m: int, r: int, n_kv: int, group: int):
    """The q-sequence case's scores of rank ``r``: ``q`` (B, n, KV, G, D) its
    rows (:func:`cp_rows` of ``chunks``, in that order) against the whole
    ``k``/``v``, block by block, each row at its own position.  Returns
    (B, n, KV, G, DV) in the same row order."""
    out, at = [], 0
    for c0, n in chunks:
        per = n // m
        out.append(_sdpa_full(q[:, at:at + per], k, v, causal=causal, q_offset=c0 + r * per,
                              n_kv=n_kv, group=group, q_rows=n))
        at += per
    return torch.cat(out, dim=1) if len(out) > 1 else out[0]


def _sdpa_qseq(q, k, v, cfg: ModelConfig, cp, *, causal: bool, n_kv: int):
    """Context parallelism: this rank's query rows against the whole K/V
    (see the module docstring); returns the attention output whole along
    the sequence, with q's heads (this rank's where they are split)."""
    mesh, m, r, heads_split = cp
    n_heads = cfg.n_heads
    b, s, h, d = q.shape
    dv = v.shape[-1]
    chunks = cp_chunks(s, m, min(Q_CHUNK_THRESHOLD, cfg.attn_q_chunk_threshold))
    pos = cp_positions(chunks, s)
    s_pad = len(pos)
    rows = tuple(cp_rows(chunks, m, i) for i in range(m))
    if s_pad != s:
        # each slot's row of q, a dummy slot's a row of zeros
        src = torch.tensor([p if p >= 0 else s for p in pos], device=q.device)
        q = F.pad(q, (0, 0, 0, 0, 0, 1)).index_select(1, src)
    if heads_split:
        # this rank's heads of every row -> every head of its rows
        heads = tuple(tuple(range(i * h, (i + 1) * h)) for i in range(m))
        q = collectives.relayout(q, mesh, 2, heads, rows, dst_dim=1)
    else:
        q = q.index_select(1, torch.tensor(rows[r], device=q.device))
    group = n_heads // n_kv
    qg = q.reshape(b, len(rows[r]), n_kv, group, d)
    out = cp_attend(qg, k, v, causal=causal, chunks=chunks, m=m, r=r, n_kv=n_kv, group=group)
    out = out.reshape(b, len(rows[r]), n_heads, dv)
    if heads_split:
        out = collectives.relayout(out, mesh, 1, rows, heads, dst_dim=2)
        order = range(s_pad)
    else:
        out = collectives.gather_along(out, mesh, ("model",), dim=1)
        order = [i for block in rows for i in block]       # rank-major slots
    # the sequence's rows in order, the dummy slots dropped
    at = {pos[slot]: k for k, slot in enumerate(order) if pos[slot] >= 0}
    take = [at[p] for p in range(s)]
    if take == list(range(s)):
        return out[:, :s] if s_pad != s else out
    return out.index_select(1, torch.tensor(take, device=out.device))


def _group_layout(n_heads: int, n_kv: int, m: int):
    """Per rank, the q heads it holds split by heads (contiguous blocks) and
    by the q group (every KV head's r-th block of its group)."""
    g, per = n_heads // n_kv, n_heads // m
    heads = tuple(tuple(range(r * per, (r + 1) * per)) for r in range(m))
    groups = tuple(tuple(j * g + r * (g // m) + i for j in range(n_kv) for i in range(g // m))
                   for r in range(m))
    return heads, groups


def sdpa(q, k, v, cfg: ModelConfig, *, causal: bool, n_kv: int | None = None):
    """Full or q-chunked attention; GQA grouping handled here.

    q: (B, S, H, D) -> out (B, S, H, DV).  Query head h reads KV head
    h // (H // KV).  ``n_kv`` is the whole KV head count (the config's
    by default; MLA's expanded heads pass H).  Split q and K/V heads (the
    KV case) are this rank's groups as they stand; split q heads against
    whole K/V (the q-group case) are relaid out to every KV head's block of
    the group for the scores, and back after.  In the q-sequence case each
    rank computes its rows (:func:`_sdpa_qseq`).
    """
    n_heads = cfg.n_heads
    n_kv = cfg.n_kv_heads if n_kv is None else n_kv
    cp = cp_split(n_heads, n_kv)
    if cp is not None:
        return _sdpa_qseq(q, k, v, cfg, cp, causal=causal, n_kv=n_kv)
    b, s, h, d = q.shape
    dv = v.shape[-1]
    group = n_heads // n_kv
    regroup = h != n_heads and k.shape[2] == n_kv
    if regroup:
        mesh, m, _ = model_axis()
        heads, groups = _group_layout(n_heads, n_kv, m)
        q = collectives.relayout(q, mesh, 2, heads, groups)
        qg = q.reshape(b, s, n_kv, group // m, d)
    else:
        kv = k.shape[2]
        qg = q.reshape(b, s, kv, h // kv, d)
    full = functools.partial(_sdpa_full, n_kv=n_kv, group=group)
    threshold = min(Q_CHUNK_THRESHOLD, cfg.attn_q_chunk_threshold)
    if s <= threshold:
        out = full(qg, k, v, causal=causal)
    else:
        # q-chunked: a ragged last block is cut, as the reference's zero
        # padding of the query axis and slice after give the same rows
        out = torch.cat([full(qg[:, i:i + Q_CHUNK], k, v, causal=causal, q_offset=i)
                         for i in range(0, s, Q_CHUNK)], dim=1)
    out = out.reshape(b, s, h, dv)
    if regroup:
        out = collectives.relayout(out, mesh, 2, groups, heads)
    return out


def attn_out(o, params, cfg: ModelConfig):
    """The output projection; a row-split ``wo`` (this rank's heads) ends in
    g, the heads' partial sums folded over ``model`` (a whole ``wo``, as in
    the q-sequence case with the heads whole, runs alike on every rank)."""
    o = constrain(o, ("batch", "seq", "heads", "head_dim"), {"heads": cfg.n_heads})
    out = torch.einsum("bshk,hkd->bsd", o, params["wo"].to(cfg.dtype("compute")))
    if params["wo"].shape[0] != cfg.n_heads:
        out = collectives.tp_reduce(out, model_axis()[0])
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


def mlp(x, params, cfg: ModelConfig, act: str = "silu", d_ff: int | None = None):
    """The gated MLP; ``d_ff`` is its whole width (the weights' own by
    default).  Column-split ``wg``/``wu`` and a row-split ``wd`` (this
    rank's width) run between f and g."""
    cd = cfg.dtype("compute")
    d_ff = params["wg"].shape[1] if d_ff is None else d_ff
    split = params["wg"].shape[1] != d_ff
    if split:
        mesh = model_axis()[0]
        x = collectives.tp_copy(x, mesh)
    g = torch.matmul(x, params["wg"].to(cd))
    u = torch.matmul(x, params["wu"].to(cd))
    h = constrain(_act(act)(g) * u, ("batch", "seq", "mlp"), {"mlp": d_ff})
    out = torch.matmul(h, params["wd"].to(cd))
    if split:
        out = collectives.tp_reduce(out, mesh)
    return constrain(out, ("batch", "seq", "embed"))
