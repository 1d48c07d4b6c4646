"""Serving: batched prefill and decode (port of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch stablelm-3b`` generates on the
card at full width from the port's seeded weights (any decoder
configuration: dense, MoE ``--arch deepseek-v2-lite-16b``, SSM ``--arch
mamba2-130m``, hybrid ``--arch zamba2-7b``); ``--reduced --device cpu``
runs a small generation on the CPU.  Without a GPU and without
``--device cpu`` it exits with an error.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.device import resolve_device
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
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        if model is None:
            model = Model(cfg, device=self.device, seed=seed)
        elif model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the server on {self.device}")
        self.model = model
        cd = cfg.dtype("compute")
        same = all(p.dtype == cd for p in model.parameters())
        self.compute = model if same else model.cast(cd)

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
        logits, cache = self.compute.prefill(batch, seq_cap)
        prompt_len = (batch["tokens"].shape[1] if "tokens" in batch
                      else batch["frames"].shape[1])
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        out = []
        tok = self._sample(logits, temperature, gen)
        for i in range(max_new_tokens):
            out.append(tok)
            logits, cache = self.compute.decode_step(cache, tok, prompt_len + i)
            tok = self._sample(logits, temperature, gen)
        return torch.cat(out, dim=1)

    @staticmethod
    def _sample(logits, temperature: float, gen):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen).to(torch.int32)


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
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced as reduce_cfg
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if cfg.is_encoder:
        raise SystemExit("encoder-only arch has no decode step")

    server = Server(cfg, device=args.device)
    batch = concrete_batch(cfg, args.batch, args.prompt_len, train=False,
                           device=args.device)
    t0 = time.perf_counter()
    toks = server.generate(batch, args.new_tokens,
                           seq_cap=args.prompt_len + args.new_tokens,
                           temperature=args.temperature).cpu()
    dt = time.perf_counter() - t0
    print(f"generated {tuple(toks.shape)} in {dt:.1f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s) on {server.device}")
    print(toks[:, :12].numpy())


if __name__ == "__main__":
    main()
