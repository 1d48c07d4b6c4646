"""The dense decoder block (port of the dense part of
``repro.models.blocks``): GQA attention and a gated MLP, each behind an
rmsnorm and a residual add.

``dense_block`` (forward), ``dense_block_prefill`` (forward plus the
layer's cache) and ``dense_block_decode`` (one token against the cache)
are plain functions of a parameter dict ``p`` with the reference's keys
(``ln1``, ``attn``, ``ln2``, ``ffn``); :class:`DenseBlock` holds one
layer's parameters as an ``nn.Module`` and calls them.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import decode as dec
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def dense_block_defs(cfg: ModelConfig) -> dict:
    return {
        "ln1": layers.rmsnorm_defs(cfg.d_model),
        "attn": layers.attn_defs(cfg),
        "ln2": layers.rmsnorm_defs(cfg.d_model),
        "ffn": layers.mlp_defs(cfg),
    }


def dense_block(x, p, cfg: ModelConfig, positions):
    x = x + layers.attention(layers.rmsnorm(x, p["ln1"], cfg.norm_eps), p["attn"],
                             cfg, positions)
    return x + layers.mlp(layers.rmsnorm(x, p["ln2"], cfg.norm_eps), p["ffn"], cfg)


def dense_block_prefill(x, p, cfg: ModelConfig, positions, seq_cap: int):
    """Returns (x, the layer's cache padded to ``seq_cap``)."""
    h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = layers.qkv_proj(h, p["attn"], cfg, positions)
    o = layers.sdpa(q, k, v, cfg, causal=cfg.causal and not cfg.is_encoder)
    x = x + layers.attn_out(o, p["attn"], cfg)
    x = x + layers.mlp(layers.rmsnorm(x, p["ln2"], cfg.norm_eps), p["ffn"], cfg)
    return x, dec.prefill_kv(k, v, seq_cap)


def dense_block_decode(x, p, cfg: ModelConfig, cache: dict, pos: int):
    """Returns (x, cache), the cache updated in place at ``pos``."""
    a, cache = dec.gqa_decode(layers.rmsnorm(x, p["ln1"], cfg.norm_eps), p["attn"],
                              cfg, cache, pos)
    x = x + a
    x = x + layers.mlp(layers.rmsnorm(x, p["ln2"], cfg.norm_eps), p["ffn"], cfg)
    return x, cache


def dense_cache_defs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    return dec.gqa_cache_defs(cfg, batch, seq)


def param_module(tree: dict) -> nn.Module:
    """A tree of tensors as nested ``nn.ModuleDict`` / ``nn.ParameterDict``
    (frozen parameters: the serving path computes no gradients)."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: param_module(v) for k, v in tree.items()})


class DenseBlock(nn.ModuleDict):
    """One dense layer's parameters, keyed as the reference's layer tree
    (``ln1``, ``attn``, ``ln2``, ``ffn``), so the block is its own ``p``."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__({k: param_module(tree[k]) for k in ("ln1", "attn", "ln2", "ffn")})
        self.cfg = cfg

    def forward(self, x, positions):
        return dense_block(x, self, self.cfg, positions)

    def prefill(self, x, positions, seq_cap: int):
        return dense_block_prefill(x, self, self.cfg, positions, seq_cap)

    def decode(self, x, cache: dict, pos: int):
        return dense_block_decode(x, self, self.cfg, cache, pos)
