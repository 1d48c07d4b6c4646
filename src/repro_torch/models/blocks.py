"""The decoder blocks (port of ``repro.models.blocks``): the dense block
(GQA or MLA attention, and a gated MLP or the MoE feed-forward, each behind
an rmsnorm and a residual add) and the Mamba-2 block (one rmsnorm, the
:mod:`~repro_torch.models.ssm` mixer, a residual add).

``dense_block`` (forward), ``dense_block_prefill`` (forward plus the
layer's cache) and ``dense_block_decode`` (one token against the cache)
are plain functions of a parameter dict ``p`` with the reference's keys
(``ln1``, ``attn``, ``ln2``, ``ffn``); ``use_moe`` picks the MoE
feed-forward (the ``moe`` stage of the DeepSeek configurations), and
``cfg.attn_type == "mla"`` picks MLA, whose cache is ``{"c_kv",
"k_rope"}`` where GQA's is ``{"k", "v"}``.  :class:`DenseBlock` holds one
layer's parameters as an ``nn.Module`` and calls them.  ``ssm_block``,
``ssm_block_prefill`` and ``ssm_block_decode`` do the same for a Mamba-2
layer (keys ``ln``, ``mixer``), whose cache is the SSM cache of
:func:`ssm.ssm_cache_defs`; they accept the attention's ``positions``,
``seq_cap`` and ``pos`` and ignore them, as the reference does, and
:class:`SSMBlock` holds one such layer.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import decode as dec
from repro_torch.models import layers, mla, moe, ssm
from repro_torch.models.config import ModelConfig


def dense_block_defs(cfg: ModelConfig, use_moe: bool = False) -> dict:
    return {
        "ln1": layers.rmsnorm_defs(cfg.d_model),
        "attn": mla.mla_defs(cfg) if cfg.attn_type == "mla" else layers.attn_defs(cfg),
        "ln2": layers.rmsnorm_defs(cfg.d_model),
        "ffn": moe.moe_defs(cfg) if use_moe else layers.mlp_defs(cfg),
    }


def _ffn(x, p, cfg: ModelConfig, use_moe: bool):
    h = layers.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if use_moe:
        return moe.moe_ffn(h, p["ffn"], cfg)
    return layers.mlp(h, p["ffn"], cfg, d_ff=cfg.d_ff)


def _attn_with_kv(x, p, cfg: ModelConfig, positions):
    """(attention output, what the layer's cache holds of this sequence)."""
    if cfg.attn_type == "mla":
        return mla.mla_attention(x, p, cfg, positions)
    q, k, v = layers.qkv_proj(x, p, cfg, positions)
    o = layers.sdpa(q, k, v, cfg, causal=cfg.causal and not cfg.is_encoder)
    return layers.attn_out(o, p, cfg), (k, v)


def dense_block(x, p, cfg: ModelConfig, positions, use_moe: bool = False):
    a, _ = _attn_with_kv(layers.rmsnorm(x, p["ln1"], cfg.norm_eps), p["attn"], cfg,
                         positions)
    x = x + a
    return x + _ffn(x, p, cfg, use_moe)


def dense_block_prefill(x, p, cfg: ModelConfig, positions, seq_cap: int,
                        use_moe: bool = False):
    """Returns (x, the layer's cache padded to ``seq_cap``)."""
    a, kv = _attn_with_kv(layers.rmsnorm(x, p["ln1"], cfg.norm_eps), p["attn"], cfg,
                          positions)
    x = x + a
    x = x + _ffn(x, p, cfg, use_moe)
    if cfg.attn_type == "mla":
        return x, mla.prefill_cache(*kv, cfg, seq_cap)
    return x, dec.prefill_kv(*kv, seq_cap, cfg.n_kv_heads)


def dense_block_decode(x, p, cfg: ModelConfig, cache: dict, pos: int,
                       use_moe: bool = False, seq_cap: int | None = None):
    """Returns (x, cache), the cache updated in place at ``pos``
    (``seq_cap``: the whole cache's length, the cache's own by default)."""
    h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, cache = mla.mla_decode(h, p["attn"], cfg, cache, pos, seq_cap)
    else:
        a, cache = dec.gqa_decode(h, p["attn"], cfg, cache, pos, seq_cap)
    x = x + a
    return x + _ffn(x, p, cfg, use_moe), cache


def dense_cache_defs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    if cfg.attn_type == "mla":
        return mla.mla_cache_defs(cfg, batch, seq)
    return dec.gqa_cache_defs(cfg, batch, seq)


def ssm_block_defs(cfg: ModelConfig) -> dict:
    return {"ln": layers.rmsnorm_defs(cfg.d_model), "mixer": ssm.ssm_defs(cfg)}


def ssm_block(x, p, cfg: ModelConfig, positions=None):
    h, _ = ssm.mamba2_forward(layers.rmsnorm(x, p["ln"], cfg.norm_eps), p["mixer"], cfg)
    return x + h


def ssm_block_prefill(x, p, cfg: ModelConfig, positions=None, seq_cap=None):
    """Returns (x, the layer's SSM cache)."""
    h, cache = ssm.mamba2_forward(layers.rmsnorm(x, p["ln"], cfg.norm_eps), p["mixer"],
                                  cfg)
    return x + h, cache


def ssm_block_decode(x, p, cfg: ModelConfig, cache: dict, pos=None, seq_cap=None):
    """Returns (x, cache), the cache updated in place."""
    h, cache = ssm.mamba2_decode(layers.rmsnorm(x, p["ln"], cfg.norm_eps), p["mixer"], cfg,
                                 cache)
    return x + h, cache


def ssm_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    return ssm.ssm_cache_defs(cfg, batch)


class ParamTree(nn.Module):
    """A tree node that holds both leaves and subtrees (the MoE ``ffn``:
    ``router``, ``wg``, ``wu``, ``wd`` beside ``shared``), indexed by key."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v))
            else:
                self.add_module(k, param_module(v))

    def __getitem__(self, key: str):
        return getattr(self, key)


def param_module(tree: dict) -> nn.Module:
    """A tree of tensors as nested ``nn.ModuleDict`` / ``nn.ParameterDict``
    (a :class:`ParamTree` where a node mixes the two) of trainable
    parameters; the serving entries (``prefill``, ``decode``) run under
    ``torch.no_grad()`` and record no graph."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})
    if any(isinstance(v, torch.Tensor) for v in tree.values()):
        return ParamTree(tree)
    return nn.ModuleDict({k: param_module(v) for k, v in tree.items()})


class DenseBlock(nn.ModuleDict):
    """One dense layer's parameters, keyed as the reference's layer tree
    (``ln1``, ``attn``, ``ln2``, ``ffn``), so the block is its own ``p``;
    ``use_moe`` for a layer of the ``moe`` stage."""

    def __init__(self, cfg: ModelConfig, tree: dict, use_moe: bool = False):
        super().__init__({k: param_module(tree[k]) for k in ("ln1", "attn", "ln2", "ffn")})
        self.cfg = cfg
        self.use_moe = use_moe

    def forward(self, x, positions):
        return dense_block(x, self, self.cfg, positions, self.use_moe)

    @torch.no_grad()
    def prefill(self, x, positions, seq_cap: int):
        return dense_block_prefill(x, self, self.cfg, positions, seq_cap, self.use_moe)

    @torch.no_grad()
    def decode(self, x, cache: dict, pos: int, seq_cap: int | None = None):
        return dense_block_decode(x, self, self.cfg, cache, pos, self.use_moe, seq_cap)


class SSMBlock(nn.ModuleDict):
    """One Mamba-2 layer's parameters, keyed as the reference's layer tree
    (``ln``, ``mixer``), with :class:`DenseBlock`'s methods."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__({k: param_module(tree[k]) for k in ("ln", "mixer")})
        self.cfg = cfg

    def forward(self, x, positions):
        return ssm_block(x, self, self.cfg)

    @torch.no_grad()
    def prefill(self, x, positions, seq_cap: int):
        return ssm_block_prefill(x, self, self.cfg)

    @torch.no_grad()
    def decode(self, x, cache: dict, pos: int, seq_cap: int | None = None):
        return ssm_block_decode(x, self, self.cfg, cache)
