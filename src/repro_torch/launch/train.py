"""Training: state construction, the train step, and a CLI driver (port of
``repro.launch.train``).

:func:`make_train_step` builds the reference's production step:
  microbatched gradient accumulation (``backward`` once per microbatch into
  ``.grad``, then ``* 1/accum``)  ->  global-norm clipping (in place)
  ->  optional int8 error-feedback compression  ->  AdamW / Adafactor
  (in place, leaf by leaf).
Each parameter's ``.grad`` holds the step's clipped gradient until the
next step clears it.  The step runs under
``torch.use_deterministic_algorithms(True)`` (:func:`deterministic`): no
float atomics in the embedding's and the loss's backward, so a resumed
run equals an uninterrupted one bit for bit on the card as on the CPU.

The driver (``python -m repro_torch.launch.train --arch ... --steps N``)
wires in the deterministic data pipeline, async checkpointing in the
reference's format, the step watchdog and resume from the latest
checkpoint.  It runs on the card unless ``--device cpu`` asks for the CPU,
and raises without one.  A sharded train state (``mesh=``) waits for the
LM multi-device path (ROADMAP queue 1).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import torch

from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import TokenStream
from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import compression
from repro_torch.distributed.fault_tolerance import StepWatchdog
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.optim.optimizers import is_stacked, leaf_shape, map_leaves, weak_scalar

MESH_LATER = ("a sharded train state (mesh=) comes with ROADMAP queue 1, the LM "
              "stack's 'LM multi-device path' part")
# cuBLAS's fixed workspace configuration, which deterministic mode asks for
# on the card; it must be in the environment before the first cuBLAS call
CUBLAS_CONFIG = ":4096:8"


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    optimizer: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    grad_accum: int = 1
    grad_compression: bool = False    # int8 EF on grads


def default_hparams_for(cfg: ModelConfig, *, global_batch: int = 256,
                        seq_len: int = 4096, data_shards: int = 16) -> TrainHParams:
    """The reference's production defaults for the train_4k shape.

    grad_accum is chosen so the remat-saved per-layer residual stream
    (n_layers x B_loc x S x d bytes under full remat) stays under ~6 GB a
    device on the reference's 16 x 16 mesh; Adafactor replaces AdamW where
    f32 moments cannot fit (deepseek-v3, at accum 4).
    """
    if cfg.name == "deepseek-v3-671b":
        return TrainHParams(optimizer="adafactor", grad_accum=4)
    b_loc = max(1, global_batch // data_shards)
    resid = cfg.n_layers * b_loc * seq_len * cfg.d_model * 2  # bf16
    accum = 1
    while resid / accum > 6e9 and accum < 16:
        accum *= 2
    return TrainHParams(grad_accum=accum)


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    """``accum`` microbatches of contiguous rows (``positions`` split on
    axis 1), the reference's reshape B -> (accum, B / accum)."""
    parts = {}
    for k, v in batch.items():
        axis = 1 if k == "positions" else 0
        b = v.shape[axis]
        if b % accum:
            raise ValueError(f"{k}: batch {b} is not a multiple of grad_accum {accum}")
        parts[k] = torch.split(v, b // accum, dim=axis)
    return [{k: p[j] for k, p in parts.items()} for j in range(accum)]


def _tensors(tree) -> list[torch.Tensor]:
    """Every tensor of ``tree``, list leaves' rows included."""
    return [t for leaf in tree_leaves(tree) for t in (leaf if is_stacked(leaf) else [leaf])]


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in _tensors(tree)))


def _make_opt(cfg: ModelConfig, hp: TrainHParams):
    sched = warmup_cosine(hp.lr, hp.warmup_steps, hp.total_steps)
    if hp.optimizer == "adamw":
        return make_optimizer("adamw", sched, weight_decay=hp.weight_decay,
                              moment_dtype=cfg.dtype("opt"))
    return make_optimizer("adafactor", sched, weight_decay=hp.weight_decay * 0.0)


def make_train_state(model: Model, hp: TrainHParams) -> dict:
    """``params`` (the model's own tensors, :meth:`Model.param_tree`),
    ``opt`` (in the reference's layout), ``step`` (an int32 tensor on the
    model's device) and, under ``grad_compression``, ``ef_err``."""
    params = model.param_tree()
    state = {"params": params, "opt": _make_opt(model.cfg, hp).init(params),
             "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    if hp.grad_compression:
        state["ef_err"] = map_leaves(
            lambda p: torch.zeros(leaf_shape(p), dtype=torch.float32, device=model.device),
            params)
    return state


@torch.no_grad()
def load_train_state(state: dict, restored: dict) -> dict:
    """Copy a restored tree (:func:`checkpoint.restore` of this state) into
    the live ``state``, tensor by tensor; returns ``state``."""
    def one(live, new):
        for a, b in zip(_tensors(live), _tensors(new), strict=True):
            a.copy_(b)
    map_leaves(one, state, restored)
    return state


@contextlib.contextmanager
def deterministic(device):
    """``torch.use_deterministic_algorithms(True)`` for the block, the
    previous mode restored after.  New memory is not filled (the step
    writes every tensor it reads).  On the card cuBLAS's workspace
    configuration is set where the environment has none; it must be there
    before the process's first cuBLAS call, as :func:`train_loop` and
    ``main`` set it."""
    if torch.device(device).type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_CONFIG)
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.utils.deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.utils.deterministic.fill_uninitialized_memory = prev[2]


class TrainStep:
    """``step(state, batch) -> (state, metrics)``, updating ``state`` in
    place; metrics ``loss``, ``ce`` (and ``mtp``), each averaged over the
    microbatches, and ``grad_norm`` (before clipping), as 0-d tensors.

    The phases are methods of their own (:meth:`grads`, :meth:`clip`,
    :meth:`apply`), so a caller can time them; ``__call__`` runs the three
    under :func:`deterministic`, as such a caller does."""

    def __init__(self, model: Model, hp: TrainHParams):
        self.model = model
        self.hp = hp
        self.optimizer = _make_opt(model.cfg, hp)

    def grads(self, state: dict, batch: dict) -> dict:
        """Forward and backward of every microbatch, the gradients summed
        into ``.grad`` and scaled by 1/accum; returns the metrics."""
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        accum = self.hp.grad_accum
        sums: dict[str, torch.Tensor] = {}
        for mb in _split_microbatches(batch, accum) if accum > 1 else [batch]:
            loss, metrics = self.model.loss(mb)
            loss.backward()
            for k, v in metrics.items():
                sums[k] = sums[k] + v.detach() if k in sums else v.detach()
        with torch.no_grad():
            for p in params:
                if p.grad is None:          # a parameter the batch does not reach
                    p.grad = torch.zeros_like(p)
                elif accum > 1:
                    p.grad.mul_(weak_scalar(1.0 / accum, p.grad.dtype))
        return {k: v * (1.0 / accum) for k, v in sums.items()} if accum > 1 else sums

    @torch.no_grad()
    def clip(self, state: dict) -> torch.Tensor:
        """Global-norm clipping of the gradients in place; returns the norm."""
        grads = [p.grad for p in _tensors(state["params"])]
        gnorm = _global_norm(grads)
        scale = torch.clamp(self.hp.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        for g in grads:
            if g.dtype == torch.float32:
                g.mul_(scale)
            else:
                g.copy_((g.float() * scale).to(g.dtype))
        return gnorm

    @torch.no_grad()
    def apply(self, state: dict) -> dict:
        """Compression (where asked for), the optimizer, the step count."""
        params = state["params"]
        grads = map_leaves(lambda p: [t.grad for t in p] if is_stacked(p) else p.grad, params)
        if self.hp.grad_compression:
            stacked = map_leaves(lambda g: torch.stack(g) if is_stacked(g) else g, grads)
            ghat, state["ef_err"] = compression.compress_tree(stacked, state["ef_err"])
            map_leaves(lambda g, h: [a.copy_(b) for a, b in zip(g, h)] if is_stacked(g)
                       else g.copy_(h), grads, ghat)
        self.optimizer.update(grads, state["opt"], params, state["step"])
        state["step"].add_(1)
        return state

    def __call__(self, state: dict, batch: dict):
        with deterministic(self.model.device):
            metrics = self.grads(state, batch)
            gnorm = self.clip(state)
            self.apply(state)
        metrics["grad_norm"] = gnorm
        return state, metrics


def make_train_step(model: Model, hp: TrainHParams) -> TrainStep:
    """Returns ``step(state, batch) -> (state, metrics)``."""
    return TrainStep(model, hp)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def train_loop(cfg: ModelConfig, hp: TrainHParams, *, batch: int, seq: int,
               steps: int, mesh=None, ckpt_dir: str | None = None,
               ckpt_every: int = 50, seed: int = 0, log_every: int = 10,
               fail_at_step: int | None = None, device=None):
    """Run (or resume) a training loop; returns (state, losses, watchdog).

    ``device`` defaults to the card and raises without one.  The model is
    drawn from ``seed``; with ``ckpt_dir`` the run resumes from the latest
    checkpoint there (state and data step) and saves every ``ckpt_every``
    steps; ``fail_at_step`` raises after that step (crash injection)."""
    if mesh is not None:
        raise NotImplementedError(MESH_LATER)
    dev = resolve_device(device)
    if dev.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_CONFIG)
    model = Model(cfg, device=dev, seed=seed)
    step_fn = make_train_step(model, hp)
    stream = TokenStream(cfg, batch, seq, seed=seed, device=dev)
    state = make_train_state(model, hp)

    start = 0
    writer = ckpt.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir is not None:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            restored, manifest = ckpt.restore(ckpt_dir, latest, state, device="cpu")
            load_train_state(state, restored)
            start = latest
            stream.restore({"step": manifest["extra"]["data_step"]})

    losses = []
    watchdog = StepWatchdog()
    try:
        for i in range(start, steps):
            batch_i = stream.next_batch()
            with watchdog:
                state, metrics = step_fn(state, batch_i)
            if fail_at_step is not None and i == fail_at_step:
                raise RuntimeError(f"injected failure at step {i}")
            loss = float(metrics["loss"])
            losses.append(loss)
            if i % log_every == 0:
                print(f"step {i:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
            if writer and (i + 1) % ckpt_every == 0:
                writer.save(i + 1, state, extra={"data_step": stream.snapshot()["step"]})
    except BaseException:
        # Crash path: drain the async queue so every checkpoint enqueued
        # before the failure is durable when the exception propagates (an
        # immediate restart would otherwise race the writer thread, see no
        # checkpoint, and replay completed steps from scratch).  Writer
        # errors must not mask the original failure.
        if writer:
            try:
                writer.close()
            except Exception:
                pass
        raise
    if writer:
        writer.close()
    return state, losses, watchdog


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU-sized) config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to train (default: the card; raises without one)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced as reduce_cfg
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    hp = default_hparams_for(cfg)
    if args.optimizer:
        hp = dataclasses.replace(hp, optimizer=args.optimizer)
    if args.grad_accum:
        hp = dataclasses.replace(hp, grad_accum=args.grad_accum)
    hp = dataclasses.replace(hp, total_steps=args.steps,
                             warmup_steps=max(1, args.steps // 10))

    t0 = time.time()
    state, losses, wd = train_loop(cfg, hp, batch=args.batch, seq=args.seq,
                                   steps=args.steps, ckpt_dir=args.ckpt_dir,
                                   device=args.device)
    dt = time.time() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s on {state['step'].device}; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"stragglers: {wd.straggler_count}")


if __name__ == "__main__":
    main()
