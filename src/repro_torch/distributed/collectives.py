"""What the reference's ``shard_map`` bodies get from ``jax.lax`` —
``axis_index``, ``psum`` and ``pmax`` over named mesh axes — on a
``torch.distributed.device_mesh.DeviceMesh``.

Every rank runs the same program (SPMD) and ends with the same bits.
Float sums are never an ``all_reduce(SUM)``: ring and tree all-reduce
pick their association order by buffer size and algorithm, so an R-round
stack could differ in bits from R single-round reductions, and NCCL from
gloo.  Instead every rank all-gathers the partials and folds them in
row-major rank order over the named axes (:func:`psum_fixed`): each
element's sum is ``p0 + p1 + ...`` in that order whatever else rides in
the buffer, so the ROADMAP's bit-for-bit rules (R rounds = R single
rounds, resume = uninterrupted) hold across ranks too.  The partials are
small (two f32 per function), so the gather costs little.

The gathers run on the default process group, which the mesh must span.
Under gloo a CUDA tensor goes to the host for the collective and comes
back, a branch on the backend (never an exception handler).
"""

from __future__ import annotations

import functools
import math
import os
from typing import Sequence

import torch
import torch.distributed as dist


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` in the mesh's axis order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axes: Sequence[str]) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in axes)


def _coord(mesh) -> dict[str, int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, (int(c) for c in coord)))


def axis_index(mesh, axes: Sequence[str]) -> int:
    """This rank's row-major index over ``axes``, the first axis slowest
    (what ``repro`` sums from ``jax.lax.axis_index`` per axis)."""
    shape, coord = mesh_shape(mesh), _coord(mesh)
    idx = 0
    for a in axes:
        idx = idx * shape[a] + coord[a]
    return idx


def local_rank() -> int:
    """This process's rank on its host: ``LOCAL_RANK`` (torchrun and
    :func:`repro_torch.launch.multihost.spawn` set it), else the global
    rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def mesh_device(mesh, device=None) -> torch.device:
    """The device this rank computes on: its card, ``LOCAL_RANK %
    device_count()``, on a ``"cuda"`` mesh, the CPU on a ``"cpu"`` one.
    A ``device`` the caller passed must be of the mesh's type."""
    kind = mesh.device_type
    if device is not None and torch.device(device).type != kind:
        raise ValueError(f"device={device!r} on a {kind!r} mesh")
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a 'cuda' mesh needs a CUDA device")
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    if kind != "cpu":
        raise ValueError(f"mesh device type must be 'cuda' or 'cpu'; got {kind!r}")
    return torch.device("cpu")


@functools.lru_cache(maxsize=256)
def _ranks_over(mesh, axes: tuple[str, ...], fixed: tuple = ()) -> tuple[int, ...]:
    """Global ranks along ``axes`` in row-major order (the first axis
    slowest), at this rank's coordinates on the other axes except the
    ``(name, index)`` pairs of ``fixed``.  Cached: the mesh's rank grid
    takes tens of microseconds to build, and a rank's answer never
    changes."""
    names = list(mesh.mesh_dim_names)
    coord = dict(_coord(mesh), **dict(fixed))
    grid = mesh.mesh[tuple(slice(None) if n in axes else coord[n] for n in names)]
    kept = [n for n in names if n in axes]
    return tuple(int(r) for r in grid.permute([kept.index(a) for a in axes]).reshape(-1))


def _gather_world(x: torch.Tensor, mesh) -> list[torch.Tensor]:
    """Every rank's ``x`` (same shape and dtype everywhere), indexed by
    global rank, on ``x``'s device."""
    world = dist.get_world_size()
    if mesh.size() != world:
        raise ValueError(f"the mesh holds {mesh.size()} ranks, the "
                         f"process group {world}: the mesh must span it")
    x = x.contiguous()
    wire = x
    if x.device.type == "cuda" and dist.get_backend() != "nccl":
        wire = x.cpu()
    parts = [torch.empty_like(wire) for _ in range(world)]
    dist.all_gather(parts, wire)
    if wire is not x:
        parts = [p.to(x.device) for p in parts]
    return parts


def _fold(parts: list[torch.Tensor]) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def gather(x: torch.Tensor, mesh, axes: Sequence[str]) -> list[torch.Tensor]:
    """The ``x`` of every rank along ``axes`` (this rank's coordinates on
    the other axes), in row-major order over ``axes``."""
    parts = _gather_world(x, mesh)
    return [parts[r] for r in _ranks_over(mesh, tuple(axes))]


def psum_fixed(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """``psum`` over ``axes`` folded in row-major rank order: the same
    bits on every rank, for every buffer size and backend."""
    return _fold(gather(x, mesh, axes))


def pmax(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Elementwise maximum over ``axes``."""
    parts = gather(x, mesh, axes)
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.maximum(acc, p)
    return acc


def gather_rows(x: torch.Tensor, mesh, fn_axis: str, dim: int = 0) -> torch.Tensor:
    """Reassemble function rows sharded over ``fn_axis``: every shard's
    ``x`` concatenated along ``dim`` in ``fn_axis`` order."""
    return torch.cat(gather(x, mesh, (fn_axis,)), dim=dim)


def psum_gather_rows(x: torch.Tensor, mesh, sample_axes: Sequence[str],
                     fn_axis: str, dim: int = 0) -> torch.Tensor:
    """:func:`psum_fixed` over ``sample_axes`` then :func:`gather_rows`
    over ``fn_axis``, the same bits, from one gather."""
    parts = _gather_world(x, mesh)
    sample_axes = tuple(sample_axes)
    return torch.cat([
        _fold([parts[r] for r in _ranks_over(mesh, sample_axes, ((fn_axis, f),))])
        for f in range(mesh_shape(mesh)[fn_axis])], dim=dim)


def barrier(mesh) -> None:
    """Wait for every rank of the mesh (its default process group)."""
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must span the process group")
    dist.barrier()
