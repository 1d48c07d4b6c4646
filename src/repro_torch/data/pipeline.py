"""Deterministic synthetic token pipeline, sharded and checkpointable (port
of ``repro.data.pipeline``).

Tokens are a pure function of (seed, step, global row, position) through
the counter-based Threefry of :mod:`repro_torch.core.rng`, so every
data-parallel shard draws exactly its rows, a restart from step k
reproduces the stream (a checkpoint stores only the step counter), and the
batches equal the reference's bit for bit.  Counters: ``c0 = step * batch
+ row`` and, for tokens, ``c1 = position``; for the stub frontends' floats
(audio ``frames``, tag 1; VLM ``vision_embeds``, tag 2) ``c1 = position *
width + feature + tag << 24``, each word wrapping at 2^32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import rng as rng_lib
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

MASK32 = rng_lib.MASK32


@dataclasses.dataclass
class StreamState:
    step: int = 0


class TokenStream:
    """Deterministic global batch stream for one (cfg, batch, seq).

    Batches are drawn on ``device`` (the card by default; raises without
    one)."""

    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.batch = global_batch
        self.seq = seq_len
        self.device = resolve_device(device)
        self.k0, self.k1 = rng_lib.fold_key(seed, stream=0xDA7A)
        self.state = StreamState()

    # -- deterministic content ---------------------------------------------------
    def _c0(self, step: int, rows: torch.Tensor) -> torch.Tensor:
        return ((step & MASK32) * self.batch + rows) & MASK32

    def _tokens(self, step: int, rows: torch.Tensor) -> torch.Tensor:
        """(len(rows), seq) int32 tokens for global batch rows at ``step``."""
        c0 = self._c0(step, rows)[:, None]
        c1 = torch.arange(self.seq, dtype=torch.int64, device=self.device)[None, :]
        bits = rng_lib.random_bits(self.k0, self.k1, c0, c1)
        return (bits % self.cfg.vocab_size).to(torch.int32)

    def _floats(self, step: int, rows: torch.Tensor, width: int, tag: int,
                n_pos: int | None = None) -> torch.Tensor:
        """(len(rows), n_pos, width) f32 in [-1, 1) for the first ``n_pos``
        positions (all ``seq`` by default)."""
        c0 = self._c0(step, rows)[:, None, None]
        n_pos = self.seq if n_pos is None else n_pos
        pos = torch.arange(n_pos, dtype=torch.int64, device=self.device)[None, :, None]
        feat = torch.arange(width, dtype=torch.int64, device=self.device)[None, None, :]
        c1 = (pos * width + feat + (tag << 24)) & MASK32
        u = rng_lib.bits_to_uniform(rng_lib.random_bits(self.k0, self.k1, c0, c1))
        return u * 2.0 - 1.0

    # -- public API ----------------------------------------------------------------
    def next_batch(self, rows=None) -> dict:
        """Next global batch (or just ``rows`` of it, for sharded hosts)."""
        step = self.state.step
        self.state.step += 1
        if rows is None:
            rows = np.arange(self.batch)
        rows = torch.as_tensor(np.asarray(rows), dtype=torch.int64, device=self.device)
        cfg = self.cfg
        if cfg.family == "encoder":
            return {"frames": self._floats(step, rows, cfg.frontend_dim, tag=1),
                    "labels": self._tokens(step, rows)}
        toks = self._tokens(step, rows)
        batch = {"tokens": toks, "labels": toks}
        if cfg.family == "vlm":
            nv = max(1, self.seq // 8)
            batch["vision_embeds"] = self._floats(step, rows, cfg.frontend_dim, tag=2, n_pos=nv)
            batch["positions"] = torch.arange(self.seq, dtype=torch.int32, device=self.device
                                              ).expand(3, len(rows), self.seq).contiguous()
        return batch

    # -- checkpointing -----------------------------------------------------------------
    def snapshot(self) -> dict:
        return {"step": self.state.step}

    def restore(self, snap: dict):
        self.state.step = int(snap["step"])
