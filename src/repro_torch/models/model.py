"""Model assembly for serving (port of ``repro.models.model``), the dense
and MoE families.

The reference stacks each stage's layers and runs them under ``lax.scan``;
here :class:`Model` is an ``nn.Module`` holding an ``nn.ModuleList`` of
:class:`~repro_torch.models.blocks.DenseBlock` and loops over it.  The
dense, encoder and vlm families are one stage of dense blocks; the moe
family (DeepSeek) is a stage of ``first_dense_layers`` dense blocks and a
stage of MoE blocks, both with MLA attention, and declares the
reference's multi-token-prediction subtree (``mtp``) where ``mtp_depth``
asks for it, which serving does not read.  The ssm and hybrid families
wait for a later slice of the port, and ``Model`` refuses them by name
(:data:`LATER_FAMILIES`).

Entries: ``forward`` (logits over the whole sequence), ``prefill``
(last-position logits and the caches, padded to ``seq_cap``) and
``decode_step`` (one token; the caches are updated in place).  A cache is a
list with one dict per block: ``{"k", "v"}`` (GQA) or ``{"c_kv",
"k_rope"}`` (MLA).  The training loss waits for the training slice;
``remat`` has no meaning in serving.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers
from repro_torch.models.config import (ModelConfig, PSpec, init_params, stack_defs,
                                       tree_map)

# Families whose blocks the port does not have yet, and the part of ROADMAP
# queue 1's LM stack item that ports them.
LATER_FAMILIES = {
    "ssm": "the SSM blocks (mamba2-130m) come with ROADMAP queue 1, the LM "
           "stack's 'SSM and hybrid' part",
    "hybrid": "the SSM and shared-attention blocks (zamba2-7b) come with ROADMAP "
              "queue 1, the LM stack's 'SSM and hybrid' part",
}


@dataclasses.dataclass(frozen=True)
class StageDesc:
    name: str
    kind: str        # dense | moe
    n_layers: int


def _stages_for(cfg: ModelConfig) -> list[StageDesc]:
    if cfg.family in ("dense", "encoder", "vlm"):
        return [StageDesc("layers", "dense", cfg.n_layers)]
    if cfg.family == "moe":
        out = []
        if cfg.first_dense_layers:
            out.append(StageDesc("dense_layers", "dense", cfg.first_dense_layers))
        out.append(StageDesc("moe_layers", "moe", cfg.n_layers - cfg.first_dense_layers))
        return out
    if cfg.family in LATER_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; "
            f"{LATER_FAMILIES[cfg.family]}")
    raise ValueError(cfg.family)


def param_defs(cfg: ModelConfig) -> dict:
    """The reference's PSpec tree for ``cfg`` (each stage's layers stacked
    under ``stages/<stage>``); ``count_params`` of it equals the reference's."""
    defs: dict[str, Any] = {"embed": layers.embed_defs(cfg)}
    defs["stages"] = {s.name: stack_defs(blocks.dense_block_defs(cfg, s.kind == "moe"),
                                         s.n_layers)
                      for s in _stages_for(cfg)}
    defs["final_norm"] = layers.rmsnorm_defs(cfg.d_model)
    if layers.head_defs(cfg):
        defs["head"] = layers.head_defs(cfg)
    if cfg.mtp_depth:
        defs["mtp"] = {
            "proj": PSpec((2 * cfg.d_model, cfg.d_model), (None, "embed")),
            "ln_h": layers.rmsnorm_defs(cfg.d_model),
            "ln_e": layers.rmsnorm_defs(cfg.d_model),
            "block": blocks.dense_block_defs(cfg),
        }
    return defs


def _layer(stacked: dict, i: int) -> dict:
    return tree_map(lambda a: a[i], stacked)


class Model(nn.Module):
    """A dense- or MoE-family LM with its parameters.

    ``device`` defaults to the card and raises without one
    (:func:`repro_torch.device.resolve_device`); ``"meta"`` builds the
    skeleton without drawing (``cast`` fills it).  Parameters are drawn in
    the reference's tree order from a ``torch.Generator`` on ``device``
    seeded with ``seed``, in ``dtype`` (the config's ``param_dtype`` by
    default): the reference's distributions, not its ``jax.random`` values.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        self.stages = _stages_for(cfg)
        dtype = dtype if dtype is not None else cfg.dtype("param")
        defs = param_defs(cfg)
        if device == "meta":
            tree = tree_map(lambda p: torch.empty(p.shape, dtype=dtype, device="meta"), defs)
        else:
            dev = resolve_device(device)
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            tree = init_params(defs, gen, dtype, dev)
        self.embed = blocks.param_module(tree["embed"])
        self.blocks = nn.ModuleList(
            blocks.DenseBlock(cfg, _layer(tree["stages"][s.name], i), s.kind == "moe")
            for s in self.stages for i in range(s.n_layers))
        self.final_norm = blocks.param_module(tree["final_norm"])
        self.head = blocks.param_module(tree["head"]) if "head" in tree else None
        # the multi-token-prediction module: carried, counted, not served
        self.mtp = blocks.param_module(tree["mtp"]) if "mtp" in tree else None

    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device

    def cast(self, dtype: torch.dtype) -> "Model":
        """A copy with every parameter cast to ``dtype`` (the serving copy in
        the compute dtype: the same bits as the reference's cast at each use)."""
        out = Model(self.cfg, device="meta", dtype=dtype)
        out.load_state_dict({k: v.to(dtype) for k, v in self.state_dict().items()},
                            assign=True)
        return out

    # -- input embedding --------------------------------------------------------
    def embed_input(self, batch: dict):
        """(x (B, S, d) in the compute dtype, positions) for a batch of
        ``tokens``, audio ``frames`` (the hubert stub) or ``tokens`` with
        ``vision_embeds`` spliced ahead and (3, B, S) M-RoPE ``positions``."""
        cfg = self.cfg
        cd = cfg.dtype("compute")
        if "frames" in batch:                     # audio stub frontend
            x = torch.matmul(batch["frames"].to(cd), self.embed["frontend_proj"].to(cd))
            positions = self._positions(x)
        elif "vision_embeds" in batch:            # VLM stub frontend
            tok = layers.embed(batch["tokens"], self.embed, cfg)
            vis = torch.matmul(batch["vision_embeds"].to(cd),
                               self.embed["frontend_proj"].to(cd))
            x = torch.cat([vis, tok[:, vis.shape[1]:]], dim=1)
            positions = batch["positions"]
        else:
            x = layers.embed(batch["tokens"], self.embed, cfg)
            positions = self._positions(x)
        return x.to(cd), positions

    @staticmethod
    def _positions(x):
        b, s = x.shape[:2]
        return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

    def logits(self, x):
        """The final norm and the head: logits (..., vocab_padded) of hidden x."""
        x = layers.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return layers.lm_head(x, self.head, self.embed, self.cfg)

    # -- forward -------------------------------------------------------------------
    def forward(self, batch: dict):
        """Logits (B, S, vocab_padded) over the whole sequence."""
        x, positions = self.embed_input(batch)
        for block in self.blocks:
            x = block(x, positions)
        return self.logits(x)

    # -- serving -------------------------------------------------------------------
    def cache_defs(self, batch: int, seq_cap: int) -> dict:
        """The reference's cache tree (layers stacked under ``stages``)."""
        return {"stages": {s.name: stack_defs(
            blocks.dense_cache_defs(self.cfg, batch, seq_cap), s.n_layers)
            for s in self.stages}}

    def init_cache(self, batch: int, seq_cap: int) -> list[dict]:
        """Zero caches in the compute dtype, one dict per block."""
        cd, dev = self.cfg.dtype("compute"), self.device
        stacked = tree_map(lambda p: torch.zeros(p.shape, dtype=cd, device=dev),
                           self.cache_defs(batch, seq_cap))
        return [_layer(stacked["stages"][s.name], i)
                for s in self.stages for i in range(s.n_layers)]

    def prefill(self, batch: dict, seq_cap: int):
        """Full-sequence forward building the caches.

        Returns (last-position logits (B, vocab_padded), caches)."""
        x, positions = self.embed_input(batch)
        caches = []
        for block in self.blocks:
            x, cache = block.prefill(x, positions, seq_cap)
            caches.append(cache)
        return self.logits(x[:, -1:])[:, 0], caches

    def decode_step(self, caches: list[dict], tokens, pos: int):
        """One decode step. tokens: (B, 1) integers; pos: their position.

        Returns (logits (B, vocab_padded), caches), updated in place."""
        x = layers.embed(tokens, self.embed, self.cfg)
        for block, cache in zip(self.blocks, caches):
            x, _ = block.decode(x, cache, pos)
        return self.logits(x)[:, 0], caches
