"""The Mamba-2 block (port of ``repro.models.ssm``): the chunked SSD scan
(state-space duality, Dao & Gu 2024, arXiv:2405.21060) for the prefill
and the one-token recurrent step for decode.

Within a chunk of ``cfg.ssm_chunk`` positions the recurrence is a masked
"attention" product; between chunks a loop carries the (B, H, P, N) state
in f32.  Decode is the O(1) step on the same state, so a layer's cache is
``{"conv_x", "conv_B", "conv_C", "state"}`` whatever the sequence length:
the last ``ssm_conv_width - 1`` inputs of each causal convolution and the
SSM state, all in the compute dtype.

The reference's rounding points are kept, each of which changes bf16
bits: the convolution is a shift-sum in ascending tap order in the compute
dtype (no ``F.conv1d``, which accumulates in f32); ``dt`` is a softplus in
f32; the (B, nc, Q, Q, H) scores are cast to the compute dtype before
their product with ``x``; chunk states and the inter-chunk recurrence are
f32; ``y`` is cast back before the ``D`` skip is added; the gate is
:func:`layers._silu`.  Under f64 compute the f32 steps run in f64.

On a mesh the block is tensor parallel over ``model`` as the reference's
rules split it (its ``ssm.py`` docstring): ``wz``/``wx``/``conv_x``/
``gate_norm``/``out`` over ``mlp`` and ``wdt``/``A_log``/``D``/``dt_bias``
over ``ssm_heads``, so each rank scans its own heads; ``wB``/``wC`` and
their convolutions are whole on every rank.  The gate norm is taken over
the whole inner width (its sum of squares folded over ``model``), and the
row-split ``out`` ends in g.  The conv and state caches rest per head
block.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig, PSpec


def ssm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.ssm_d_inner
    n = cfg.ssm_state
    h = cfg.ssm_heads
    w = cfg.ssm_conv_width
    return {
        "wz": PSpec((d, di), ("embed", "mlp")),
        "wx": PSpec((d, di), ("embed", "mlp")),
        "wB": PSpec((d, n), ("embed", "ssm_state")),
        "wC": PSpec((d, n), ("embed", "ssm_state")),
        "wdt": PSpec((d, h), ("embed", "ssm_heads")),
        "conv_x": PSpec((w, di), ("conv", "mlp"), scale=0.5),
        "conv_B": PSpec((w, n), ("conv", "ssm_state"), scale=0.5),
        "conv_C": PSpec((w, n), ("conv", "ssm_state"), scale=0.5),
        "A_log": PSpec((h,), ("ssm_heads",), init="zeros"),
        "D": PSpec((h,), ("ssm_heads",), init="ones"),
        "dt_bias": PSpec((h,), ("ssm_heads",), init="zeros"),
        "gate_norm": PSpec((di,), ("mlp",), init="ones"),
        "out": PSpec((di, d), ("mlp", "embed")),
    }


def _causal_conv(u, w, cache=None):
    """Depthwise causal convolution as a shift-sum, then silu.

    u: (B, L, C); w: (W, C); cache: (B, W-1, C), the previous inputs, or
    None for zeros.  Returns (y (B, L, C), the last W-1 inputs).
    """
    width, length = w.shape[0], u.shape[1]
    if cache is None:
        pad = u.new_zeros((u.shape[0], width - 1) + tuple(u.shape[2:]))
    else:
        pad = cache.to(u.dtype)
    full = torch.cat([pad, u], dim=1)                  # (B, W-1+L, C)
    y = full[:, :length] * w[0]
    for i in range(1, width):
        y = y + full[:, i:i + length] * w[i]
    return layers._silu(y), full[:, -(width - 1):]


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0): max(x, 0) + log1p(exp(-|x|))
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _decay(t):
    """exp of a log-decay clipped to [-60, 0]."""
    return torch.exp(torch.clamp(t, -60.0, 0.0))


def _ssd_chunked(x, dt, a_log, bmat, cmat, chunk: int):
    """Chunked SSD scan.

    x: (B, L, H, P); dt: (B, L, H) (after the softplus); a_log: (H,);
    bmat/cmat: (B, L, N) (one group, shared by the heads); L a multiple of
    ``chunk``.  Returns (y (B, L, H, P) in x's dtype, the final state
    (B, H, P, N) in f32).
    """
    b, l, h, p = x.shape
    n = bmat.shape[-1]
    if l % chunk:
        raise ValueError(f"length {l} is not a multiple of the chunk {chunk}")
    nc = l // chunk
    f32 = torch.promote_types(x.dtype, torch.float32)   # f32, or f64 under f64 compute

    a = -torch.exp(a_log.to(f32))                       # (H,) negative
    xr = x.reshape(b, nc, chunk, h, p)
    dtr = dt.reshape(b, nc, chunk, h).to(f32)
    br = bmat.reshape(b, nc, chunk, n).to(f32)
    cr = cmat.reshape(b, nc, chunk, n).to(f32)

    cum = torch.cumsum(dtr * a, dim=2)                  # (B, nc, Q, H)
    total = cum[:, :, -1]                               # (B, nc, H)

    # -- within each chunk (quadratic in the chunk) --
    cb = torch.einsum("bcqn,bckn->bcqk", cr, br)        # (B, nc, Q, Q)
    # decay(q, k, h) = exp(cum_q - cum_k), masked to k <= q
    decay = _decay(cum[:, :, :, None, :] - cum[:, :, None, :, :])   # (B, nc, Q, Q, H)
    qi = torch.arange(chunk, device=x.device)
    causal = (qi[:, None] >= qi[None, :]).to(f32)
    scores = cb[..., None] * decay * causal[None, None, :, :, None]
    scores = scores * dtr[:, :, None, :, :]             # dt_k folded in
    # the scores in the compute dtype before their product, as the reference
    scores = scores.to(x.dtype)
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", scores, xr)

    # -- each chunk's own state: sum_k B_k (decay to the chunk's end) dt_k x_k --
    weight = _decay(total[:, :, None, :] - cum) * dtr   # (B, nc, Q, H)
    s_chunk = torch.einsum("bckn,bckhp->bchpn", br, xr.to(f32) * weight[..., None])

    # -- between chunks: the state entering each chunk, then its read-out --
    s = x.new_zeros((b, h, p, n), dtype=f32)
    entering = []
    end_decay = _decay(total)                           # (B, nc, H)
    for c in range(nc):
        entering.append(s)
        s = s * end_decay[:, c, :, None, None] + s_chunk[:, c]
    s_in = torch.stack(entering, dim=1)                 # (B, nc, H, P, N)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", cr, s_in) * _decay(cum)[..., None]

    y = (y_diag + y_off).reshape(b, l, h, p).to(x.dtype)
    return y, s


def _split(p, cfg: ModelConfig):
    """The mesh where this rank holds a block of the heads, else None."""
    return layers.model_axis()[0] if p["wz"].shape[1] != cfg.ssm_d_inner else None


def _in_proj(x, p, cfg: ModelConfig, cd, mesh):
    """z, x, B, C and dt: the block's five input projections (``x`` enters
    through f where the heads are split)."""
    if mesh is not None:
        x = collectives.tp_copy(x, mesh)
    z, xin, bmat, cmat, dt = (torch.matmul(x, p[k].to(cd))
                              for k in ("wz", "wx", "wB", "wC", "wdt"))
    width = {"mlp": cfg.ssm_d_inner}
    xin = sh.constrain(xin, ("batch", "seq", "mlp"), width)
    z = sh.constrain(z, ("batch", "seq", "mlp"), width)
    return z, xin, bmat, cmat, dt


def _gate_out(y, z, p, cfg: ModelConfig, cd, mesh):
    y = y * layers._silu(z)
    if mesh is None:
        y = layers.rmsnorm(y, {"scale": p["gate_norm"]}, cfg.norm_eps)
    else:
        # the norm over the whole inner width: its sum of squares over model
        ss = torch.sum(torch.square(y.float()), dim=-1, keepdim=True)
        var = collectives.tp_sum(ss, mesh) / cfg.ssm_d_inner
        inv = torch.rsqrt(var + cfg.norm_eps).to(y.dtype)
        y = y * inv * p["gate_norm"].to(y.dtype)
    out = torch.matmul(y, p["out"].to(cd))
    if mesh is not None:
        out = collectives.tp_reduce(out, mesh)
    return sh.constrain(out, ("batch", "seq", "embed"))


def mamba2_forward(x, p, cfg: ModelConfig):
    """The block over a whole sequence (forward and prefill).

    Returns (out (B, L, d), the cache: the convolutions' last inputs and the
    final SSM state, in the compute dtype)."""
    cd = cfg.dtype("compute")
    b, l, _ = x.shape
    h, pn = p["A_log"].shape[0], cfg.ssm_head_dim     # this rank's heads

    mesh = _split(p, cfg)
    z, xin, bmat, cmat, dt = _in_proj(x, p, cfg, cd, mesh)
    xin, conv_x = _causal_conv(xin, p["conv_x"].to(cd))
    bmat, conv_b = _causal_conv(bmat, p["conv_B"].to(cd))
    cmat, conv_c = _causal_conv(cmat, p["conv_C"].to(cd))
    dt = _softplus(dt.float() + p["dt_bias"].float())
    xh = xin.reshape(b, l, h, pn)

    # pad to a chunk multiple: padded steps have dt = 0, so a decay of 1 and
    # nothing added to the state, which leaves the final state as it is
    chunk = cfg.ssm_chunk
    pad = -(-l // chunk) * chunk - l
    if pad:
        xh_p = torch.nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
        dt_p, b_p, c_p = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                          for t in (dt, bmat, cmat))
    else:
        xh_p, dt_p, b_p, c_p = xh, dt, bmat, cmat
    y, s_final = _ssd_chunked(xh_p, dt_p, p["A_log"], b_p, c_p, chunk)
    y = y[:, :l] + p["D"].to(cd)[None, None, :, None] * xh
    out = _gate_out(y.reshape(b, l, h * pn), z, p, cfg, cd, mesh)
    # the tails copied out of the padded inputs, which the cache would keep alive
    return out, {"conv_x": conv_x.clone(), "conv_B": conv_b.clone(),
                 "conv_C": conv_c.clone(), "state": s_final.to(cd)}


def mamba2_decode(x, p, cfg: ModelConfig, cache: dict):
    """The O(1) recurrent step.  x: (B, 1, d).  Returns (out (B, 1, d),
    cache), the cache's four leaves updated in place."""
    cd = cfg.dtype("compute")
    f32 = torch.promote_types(cd, torch.float32)       # f32, or f64 under f64 compute
    b = x.shape[0]
    h, pn = p["A_log"].shape[0], cfg.ssm_head_dim     # this rank's heads

    mesh = _split(p, cfg)
    z, xin, bmat, cmat, dt = _in_proj(x, p, cfg, cd, mesh)
    xin, cx = _causal_conv(xin, p["conv_x"].to(cd), cache["conv_x"])
    bmat, cb = _causal_conv(bmat, p["conv_B"].to(cd), cache["conv_B"])
    cmat, cc = _causal_conv(cmat, p["conv_C"].to(cd), cache["conv_C"])

    dt = _softplus(dt.float() + p["dt_bias"].float())[:, 0]          # (B, H)
    da = torch.exp(dt * -torch.exp(p["A_log"].to(f32)))              # (B, H)
    xh = xin.reshape(b, h, pn).to(f32)
    contrib = (xh * dt[:, :, None])[..., None] * bmat[:, 0].to(f32)[:, None, None, :]
    state = cache["state"].to(f32) * da[:, :, None, None] + contrib  # (B, H, P, N)
    y = torch.einsum("bhpn,bn->bhp", state, cmat[:, 0].to(f32))
    y = y.to(cd) + p["D"].to(cd)[None, :, None] * xh.to(cd)
    out = _gate_out(y.reshape(b, 1, h * pn), z, p, cfg, cd, mesh)

    cache["conv_x"].copy_(cx)
    cache["conv_B"].copy_(cb)
    cache["conv_C"].copy_(cc)
    cache["state"].copy_(state)
    return out, cache


def ssm_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    """One layer's decode cache (its size does not grow with the sequence)."""
    w = cfg.ssm_conv_width
    return {
        "conv_x": PSpec((batch, w - 1, cfg.ssm_d_inner), ("batch", None, "mlp"),
                        init="zeros"),
        "conv_B": PSpec((batch, w - 1, cfg.ssm_state), ("batch", None, "ssm_state"),
                        init="zeros"),
        "conv_C": PSpec((batch, w - 1, cfg.ssm_state), ("batch", None, "ssm_state"),
                        init="zeros"),
        "state": PSpec((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                       ("batch", "ssm_heads", None, None), init="zeros"),
    }
