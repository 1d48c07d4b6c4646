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
and raises without one.

On a mesh (``train_loop(mesh=)``, ``TrainStep(..., mesh=)``, the CLI's
``--mesh --ranks N``) every leaf of the state rests as this rank's block
under the reference's specs (:func:`train_state_specs`,
:mod:`repro_torch.distributed.sharding`), and the step follows the
schedule of :mod:`repro_torch.distributed.fsdp`: the global batch is split
into microbatches first, each microbatch's rows over the batch axes
second; each rank runs its rows tensor parallel over ``model`` (its heads,
widths and vocab columns, the residual stream the same on every ``model``
rank between Megatron's f and g), every other weight gathered over the
axes of its spec, and the gradient's deterministic reduce-scatter leaves
each rank the sum of its block (over ``model`` too for a leaf each
``model`` rank uses for its own block: :func:`fsdp.leaf_role`).  The
clip counts each block once.  The clip's sum of squares, the metrics, the int8
compression's scales and Adafactor's factored statistics are gathers folded
in rank order (no float ``all_reduce``), so a run repeats and resumes bit
for bit on the same mesh; the loss and the gradients equal one device's up
to association order.  Checkpoints gather each leaf to rank 0, which writes
the reference's format, and restore reads each rank's block alone.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import sys
import time

import torch

from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import TokenStream
from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import collectives, compression, fsdp
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.fault_tolerance import StepWatchdog
from repro_torch.launch import multihost
from repro_torch.launch.mesh import launcher_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.optim import make_optimizer, opt_state_specs, warmup_cosine
from repro_torch.optim.optimizers import is_stacked, leaf_shape, map_leaves, weak_scalar
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


def abstract_train_state(model: Model, hp: TrainHParams) -> dict:
    """The reference's train-state tree as ``meta`` tensors (stacked stage
    leaves): shapes and dtypes, no storage."""
    params = model.abstract()
    state = {"params": params, "opt": _make_opt(model.cfg, hp).init(params),
             "step": torch.empty((), dtype=torch.int32, device="meta")}
    if hp.grad_compression:
        state["ef_err"] = map_leaves(
            lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"), params)
    return state


def train_state_specs(model: Model, hp: TrainHParams) -> dict:
    """Logical-axes tree matching :func:`abstract_train_state`."""
    p_specs = model.specs()
    specs: dict = {"params": p_specs,
                   "opt": opt_state_specs(hp.optimizer, model.abstract(), p_specs),
                   "step": ()}
    if hp.grad_compression:
        specs["ef_err"] = p_specs
    return specs


def train_shardings(model: Model, hp: TrainHParams, mesh, rules=None) -> dict:
    """Every train-state leaf's :class:`~repro_torch.distributed.sharding.NamedSharding`
    on ``mesh`` (the reference's ``tree_shardings`` of the two trees above)."""
    rules = sh.rules_for(model.cfg) if rules is None else rules
    return sh.tree_shardings(abstract_train_state(model, hp), train_state_specs(model, hp),
                             mesh, rules)


def make_mesh_train_state(model: Model, hp: TrainHParams, mesh) -> dict:
    """The train state of a sharded model (:func:`fsdp.shard_model`): its
    parameter blocks, and zero blocks of the optimizer state (and
    ``ef_err``) under their own specs."""
    abstract = abstract_train_state(model, hp)
    shard = train_shardings(model, hp, mesh, model.param_source.rules)
    dev = collectives.mesh_device(mesh)
    state = {"params": model.param_tree(),
             "opt": fsdp.zeros_like_tree(abstract["opt"], shard["opt"], dev),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if hp.grad_compression:
        state["ef_err"] = fsdp.zeros_like_tree(abstract["ef_err"], shard["ef_err"], dev)
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


def mesh_rows(rows: int, accum: int, mesh, rules, seq: int) -> tuple[list[int], tuple, int]:
    """(this rank's rows of a global batch of ``rows``, the batch axes, the
    number of ranks along them): microbatches of contiguous rows first, then
    each microbatch's rows split over the batch axes."""
    mb = rows // accum
    axes = fsdp.batch_axes(mesh, rules, mb, seq)
    sizes = sh.mesh_axes(mesh)
    n = math.prod(sizes[a] for a in axes)
    i = collectives.axis_index(mesh, axes) if axes else 0
    per = mb // n
    return [j * mb + i * per + r for j in range(accum) for r in range(per)], axes, n


class MeshTrainStep(TrainStep):
    """:class:`TrainStep` of a sharded model (:func:`fsdp.shard_model`) on
    ``mesh``: ``step(state, batch)`` takes the global batch and runs this
    rank's rows (:func:`mesh_rows`); the state's leaves are this rank's
    blocks (:func:`make_mesh_train_state`)."""

    def __init__(self, model: Model, hp: TrainHParams, mesh):
        super().__init__(model, hp)
        if model.param_source is None:
            raise ValueError("a mesh step needs a sharded model (fsdp.shard_model)")
        self.mesh = mesh
        self.gather = model.param_source
        self.rules = self.gather.rules
        self.abstract = abstract_train_state(model, hp)
        self.shardings = train_shardings(model, hp, mesh, self.rules)
        coords = sh.mesh_coords(mesh)
        self._names = [n for n, _ in model.named_parameters()]
        # per parameter: the mesh positions (row-major) holding distinct blocks
        self._owners = []
        for n in self._names:
            used = set(sh.sharded_axes(self.gather.layout[n][1]))
            self._owners.append([k for k, c in enumerate(coords)
                                 if all(c[a] == 0 for a in c if a not in used)])

    def grads(self, state: dict, batch: dict) -> dict:
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        accum = self.hp.grad_accum
        key = "frames" if "frames" in batch else "tokens"
        rows_total, seq = batch[key].shape[:2]
        rows, axes, n_b = mesh_rows(rows_total, accum, self.mesh, self.rules, seq)
        self.gather.set_batch(rows_total // accum, seq)
        idx = torch.as_tensor(rows, device=batch[key].device)
        local = {k: (v.index_select(1, idx) if k == "positions" else v.index_select(0, idx))
                 for k, v in batch.items()}
        sums: dict[str, torch.Tensor] = {}
        per = len(rows) // accum
        with sh.logical_sharding(self.mesh, self.rules), \
                sh.local_batch(per, rows_total // accum):
            for mb in _split_microbatches(local, accum) if accum > 1 else [local]:
                with self.gather.top():
                    loss, metrics = self.model.loss(mb)
                    (loss * (1.0 / n_b) if n_b > 1 else loss).backward()
                for k, v in metrics.items():
                    sums[k] = sums[k] + v.detach() if k in sums else v.detach()
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                elif accum > 1:
                    p.grad.mul_(weak_scalar(1.0 / accum, p.grad.dtype))
            names = sorted(sums)
            vec = torch.stack([sums[k] for k in names])
            if n_b > 1:
                vec = collectives.fold_axes(vec * (1.0 / n_b), self.mesh, axes)
            if accum > 1:
                vec = vec * (1.0 / accum)
        return dict(zip(names, vec.unbind(0)))

    @torch.no_grad()
    def clip(self, state: dict) -> torch.Tensor:
        params = list(self.model.parameters())
        partial = torch.stack([torch.sum(torch.square(p.grad.float())) for p in params])
        world = collectives.all_gather_axes(partial, self.mesh, tuple(sh.mesh_axes(self.mesh)))
        total = None
        for j, owners in enumerate(self._owners):
            leaf = world[owners[0]][j]
            for k in owners[1:]:
                leaf = leaf + world[k][j]
            total = leaf if total is None else total + leaf
        gnorm = torch.sqrt(total)
        scale = torch.clamp(self.hp.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        for p in params:
            g = p.grad
            if g.dtype == torch.float32:
                g.mul_(scale)
            else:
                g.copy_((g.float() * scale).to(g.dtype))
        return gnorm

    def _axes(self, sharding) -> tuple[str, ...]:
        sizes = sh.mesh_axes(self.mesh)
        return tuple(a for a in sh.sharded_axes(sharding.spec) if sizes[a] > 1)

    def _whole(self, t: torch.Tensor, shape, sharding) -> torch.Tensor:
        axes = self._axes(sharding)
        if not axes:
            return t
        plan = fsdp.leaf_plan(shape, sharding.spec, self.mesh, axes, (), self.gather.coord)
        return fsdp.gather_leaf(t, self.mesh, plan)

    @torch.no_grad()
    def apply(self, state: dict) -> dict:
        params = state["params"]
        grads = map_leaves(lambda p: [t.grad for t in p] if is_stacked(p) else p.grad, params)
        shard_p = self.shardings["params"]
        if self.hp.grad_compression:
            def compress(g, err, s):
                stacked = torch.stack(g) if is_stacked(g) else g
                target = stacked.float() + err
                amax = torch.max(torch.abs(target)).float()
                axes = self._axes(s)
                if axes:
                    amax = torch.stack(collectives.all_gather_axes(amax, self.mesh, axes)).amax()
                ghat, new_err = compression.ef_compress(stacked, err, amax=amax)
                err.copy_(new_err)
                if is_stacked(g):
                    for a, b in zip(g, ghat.unbind(0)):
                        a.copy_(b)
                else:
                    g.copy_(ghat)
            map_leaves(compress, grads, state["ef_err"], shard_p)
        if self.optimizer.kind == "adamw":
            # elementwise: each rank updates its blocks
            self.optimizer.update(grads, state["opt"], params, state["step"])
        else:
            self._apply_whole(grads, state, shard_p)
        state["step"].add_(1)
        return state

    def _apply_whole(self, grads, state, shard_p):
        """A non-elementwise optimizer (Adafactor: factored row and column
        statistics, the update's RMS): each leaf's gradient, parameter and
        state gathered whole, updated as on one device, and cut back."""
        abstract, shard_o = self.abstract, self.shardings["opt"]
        coord = self.gather.coord

        def one(g, p, s_opt, sp, so, ap, ao):
            stacked = is_stacked(p)
            shape = tuple(ap.shape)
            per = shape[1:] if stacked else shape
            per_s = sh.NamedSharding(self.mesh, tuple(sp.spec[1:]) if stacked else sp.spec)
            gw = [self._whole(t, per, per_s) for t in g] if stacked else self._whole(g, per, per_s)
            pw = [self._whole(t, per, per_s) for t in p] if stacked else self._whole(p, per, per_s)
            sw = map_leaves(lambda t, s, a: self._whole(t, a.shape, s), s_opt, so, ao)
            self.optimizer.update({"x": gw}, {"x": sw}, {"x": pw}, state["step"])
            for live, whole in zip(p if stacked else [p], pw if stacked else [pw]):
                if whole is not live:
                    live.copy_(whole[per_s.slices(per, coord)])
            map_leaves(lambda t, w, s, a: t.copy_(w[s.slices(a.shape, coord)]) if w is not t
                       else None, s_opt, sw, so, ao)

        map_leaves(one, grads, state["params"], state["opt"], shard_p, shard_o,
                   abstract["params"], abstract["opt"])


def make_train_step(model: Model, hp: TrainHParams, mesh=None) -> TrainStep:
    """Returns ``step(state, batch) -> (state, metrics)``; on ``mesh`` a
    :class:`MeshTrainStep` of a sharded model."""
    return TrainStep(model, hp) if mesh is None else MeshTrainStep(model, hp, mesh)


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
    steps; ``fail_at_step`` raises after that step (crash injection).  On
    ``mesh`` (a ``DeviceMesh``; every rank calls this) the state is this
    rank's blocks, the model the same one device would draw, and a
    checkpoint from any mesh or one device resumes here."""
    dev = resolve_device(device) if mesh is None else collectives.mesh_device(mesh, device)
    if dev.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_CONFIG)
    if mesh is None:
        model = Model(cfg, device=dev, seed=seed)
        state = make_train_state(model, hp)
    else:
        model = fsdp.shard_model(Model(cfg, device="meta"), mesh, seed=seed, device=dev)
        state = make_mesh_train_state(model, hp, mesh)
    step_fn = make_train_step(model, hp, mesh)
    shardings = step_fn.shardings if mesh is not None else None
    stream = TokenStream(cfg, batch, seq, seed=seed, device=dev)
    talk = mesh is None or collectives.dist.get_rank() == 0

    start = 0
    writer = ckpt.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir is not None:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            restored, manifest = ckpt.restore(ckpt_dir, latest, state, device="cpu",
                                              shardings=shardings)
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
            if i % log_every == 0 and talk:
                print(f"step {i:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
            if writer and (i + 1) % ckpt_every == 0:
                writer.save(i + 1, state, extra={"data_step": stream.snapshot()["step"]},
                            shardings=shardings)
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
    multihost.add_mesh_args(ap)
    args = ap.parse_args(argv)

    if args.mesh and not multihost.initialize_if_needed(
            verbose=False, device=args.device, backend=args.backend):
        return multihost.spawn_launcher(main, args, sys.argv[1:] if argv is None else argv)
    mesh = launcher_mesh(args.device) if args.mesh else None

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
                                   device=args.device, mesh=mesh)
    dt = time.time() - t0
    if mesh is None or collectives.dist.get_rank() == 0:
        where = state["step"].device if mesh is None else f"mesh {sh.mesh_axes(mesh)}"
        print(f"done: {args.steps} steps in {dt:.1f}s on {where}; "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"stragglers: {wd.straggler_count}")
    return losses


if __name__ == "__main__":
    main()
