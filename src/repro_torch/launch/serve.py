"""Serving: batched prefill and decode (port of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch stablelm-3b`` generates on the
card at full width from the port's seeded weights (any decoder
configuration: dense, MoE ``--arch deepseek-v2-lite-16b``, SSM ``--arch
mamba2-130m``, hybrid ``--arch zamba2-7b``); ``--reduced --device cpu``
runs a small generation on the CPU.  Without a GPU and without
``--device cpu`` it exits with an error.

``Server(cfg, mesh=)`` (every rank builds one; ``--mesh --ranks N`` on the
CLI) serves on a mesh: each rank draws its parameter blocks
(:func:`repro_torch.distributed.fsdp.shard_model`, one device's values;
or takes a model so sharded as ``model``) and keeps them, cast to the
compute dtype.  Every step computes on them as the training step does:
tensor parallel over ``model`` (heads, MLP width, vocab, SSM heads; the
routed experts as the MoE island), each leaf gathered over its other axes
at its use.  The caches rest as their specs
give each rank: the sequence split over ``model`` where it divides
``seq_cap`` (flash-decoding, :mod:`repro_torch.models.decode`).  The
global batch is split over the batch axes (each rank prefills and decodes
its rows).  Greedy decoding takes the argmax over the vocab shards (the
first index at the global maximum, as ``torch.argmax`` picks); sampling
gathers the logits first.  ``generate`` gathers every rank's tokens, so
every rank returns the whole batch's.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import sys
import time

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.distributed import collectives, fsdp
from repro_torch.distributed import sharding as sh
from repro_torch.launch import multihost
from repro_torch.launch.specs import concrete_batch
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


class Server:
    """Minimal batched generation over :class:`Model` prefill / decode.

    ``model`` (built from ``seed`` on ``device`` when not given) keeps the
    parameters in their stored dtype.  Where that is not the compute dtype
    (stablelm-3b stores f32 and computes in bf16), the server keeps one copy
    cast to the compute dtype at load time, ``compute``, and serves from it:
    the same bits as the reference's cast of each weight at every use, without
    reading the f32 weights and casting them again at every step.  The
    parameters are trainable; ``generate`` runs under ``torch.no_grad()``
    and records no graph.
    """

    def __init__(self, cfg: ModelConfig, model: Model | None = None, *, device=None,
                 seed: int = 0, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.rules = sh.rules_for(cfg)
        cd = cfg.dtype("compute")
        if mesh is not None:
            if model is not None and model.param_source is None:
                raise ValueError("a mesh server takes a model of this rank's blocks "
                                 "(fsdp.shard_model) or draws its own: pass no model")
            self.device = collectives.mesh_device(mesh, device)
            if model is None:
                model = fsdp.shard_model(Model(cfg, device="meta"), mesh, seed=seed,
                                         device=self.device)
            for name, p in list(model.named_parameters()):
                prefix, _, key = name.rpartition(".")
                model.get_submodule(prefix)._parameters[key] = nn.Parameter(
                    p.detach().to(cd), requires_grad=False)
            self.model = self.compute = model
            return
        self.device = resolve_device(device)
        if model is None:
            model = Model(cfg, device=self.device, seed=seed)
        elif model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the server on {self.device}")
        self.model = model
        same = all(p.dtype == cd for p in model.parameters())
        self.compute = model if same else model.cast(cd)

    def local(self, batch: dict) -> tuple[dict, tuple]:
        """(this rank's rows of a global batch, the batch axes): on one
        device the whole batch and ``()``."""
        if self.mesh is None:
            return batch, ()
        key = "tokens" if "tokens" in batch else "frames"
        rows, seq = batch[key].shape[:2]
        axes = fsdp.batch_axes(self.mesh, self.rules, rows, seq)
        n = math.prod(sh.mesh_axes(self.mesh)[a] for a in axes)
        i = collectives.axis_index(self.mesh, axes) if axes else 0
        per = rows // n
        return ({k: v[:, i * per:(i + 1) * per] if k == "positions" else v[i * per:(i + 1) * per]
                 for k, v in batch.items()}, axes)

    @contextlib.contextmanager
    def context(self, rows: int, total: int | None = None):
        """The mesh and rules model code sees (tensor parallelism, the MoE
        island, ``constrain``'s checks of this rank's ``rows`` of a global
        batch of ``total``); nothing on one device."""
        if self.mesh is None:
            yield
            return
        with sh.logical_sharding(self.mesh, self.rules), sh.local_batch(rows, total):
            yield

    @torch.no_grad()
    def generate(self, batch: dict, max_new_tokens: int, seq_cap: int,
                 temperature: float = 0.0, seed: int = 0) -> torch.Tensor:
        """Greedy (``argmax``) or temperature generation from a fresh cache.

        Returns (B, max_new_tokens) int32 on the server's device.  Sampling
        at ``temperature > 0`` draws from a ``torch.Generator`` seeded with
        ``seed``; its tokens are not those of the reference's
        ``jax.random.categorical``.
        """
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        key = "tokens" if "tokens" in batch else "frames"
        total = batch[key].shape[0]
        batch, axes = self.local(batch)
        prompt_len = batch[key].shape[1]
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        out = []
        with self.context(batch[key].shape[0], total):
            logits, cache = self.compute.prefill(batch, seq_cap)
            tok = self._sample(logits, temperature, gen)
            for i in range(max_new_tokens):
                out.append(tok)
                logits, cache = self.compute.decode_step(cache, tok, prompt_len + i, seq_cap)
                tok = self._sample(logits, temperature, gen)
        toks = torch.cat(out, dim=1)
        if axes:
            toks = torch.cat(collectives.all_gather_axes(toks, self.mesh, axes))
        return toks

    def _sample(self, logits, temperature: float, gen):
        """The next tokens (B, 1) int32 from this rank's logits: on a mesh
        with a vocab-split head, greedy is the first index at the maximum
        over every rank's columns, and sampling gathers the columns first."""
        n = logits.shape[-1]
        if n != self.cfg.vocab_padded:
            if temperature > 0.0:
                logits = torch.cat(collectives.all_gather_axes(logits, self.mesh, ("model",)),
                                   dim=-1)
            else:
                return self.argmax_over_vocab(logits)
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen).to(torch.int32)

    def argmax_over_vocab(self, logits):
        """``torch.argmax`` of the whole rows of vocab-split ``logits``: each
        rank's maximum and its (global) index, gathered over ``model``; the
        first rank with the largest value wins ties, as its index is lower."""
        n = logits.shape[-1]
        r = collectives.axis_index(self.mesh, ("model",))
        idx = torch.argmax(logits, dim=-1)
        val = torch.take_along_dim(logits, idx[:, None], dim=-1)[:, 0].float()
        best = None
        for part in collectives.all_gather_axes(torch.stack([val, (idx + r * n).float()], -1),
                                                self.mesh, ("model",)):
            best = part if best is None else torch.where(part[:, :1] > best[:, :1], part, best)
        return best[:, 1:].to(torch.int32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to serve (default: the card; raises without one)")
    multihost.add_mesh_args(ap)
    args = ap.parse_args(argv)

    if args.mesh and not multihost.initialize_if_needed(
            verbose=False, device=args.device, backend=args.backend):
        return multihost.spawn_launcher(main, args, sys.argv[1:] if argv is None else argv)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_mesh_for
        world = collectives.dist.get_world_size()
        mesh = make_mesh_for(model_parallel=world, device=args.device)

    from repro_torch.configs import get_config, reduced as reduce_cfg
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if cfg.is_encoder:
        raise SystemExit("encoder-only arch has no decode step")

    server = Server(cfg, device=args.device, mesh=mesh)
    batch = concrete_batch(cfg, args.batch, args.prompt_len, train=False,
                           device=server.device)
    t0 = time.perf_counter()
    toks = server.generate(batch, args.new_tokens,
                           seq_cap=args.prompt_len + args.new_tokens,
                           temperature=args.temperature).cpu()
    dt = time.perf_counter() - t0
    if mesh is None or collectives.dist.get_rank() == 0:
        where = server.device if mesh is None else f"mesh {sh.mesh_axes(mesh)}"
        print(f"generated {tuple(toks.shape)} in {dt:.1f}s "
              f"({args.batch * args.new_tokens / dt:.1f} tok/s) on {where}")
        print(toks[:, :12].numpy())
    return toks.numpy().tolist()


if __name__ == "__main__":
    main()
