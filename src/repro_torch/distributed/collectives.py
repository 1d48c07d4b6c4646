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

The LM multi-device path adds collectives over the subgroup of ranks along
some mesh axes (:func:`axis_group`: one ``new_group`` per coset, made on
every rank at first use, in the same program order): :func:`all_gather_axes`,
:func:`all_reduce` (a gather folded in rank order, or above a MiB over
three or more ranks each member's fold of 1/n of the elements gathered:
the same bits; counted as an all-reduce) with tensor parallelism's
operators on it (:func:`tp_copy`,
Megatron's f; :func:`tp_reduce`, its g; :func:`tp_sum`), the head
:func:`relayout` and flash-decoding's :func:`merge_partials`,
the deterministic reduce-scatter :func:`reduce_scatter_fixed` (an
``all_to_all`` of the pieces each rank owns, folded in rank order: no float
``all_reduce``), :func:`fold_axes`, :func:`all_to_all` and the slice/gather
pair along a chosen dim (:func:`slice_along`, :func:`gather_along`: the
expert-parallel island's tokens, the q-sequence case's attention rows and
sequence parallelism's carry) with their autograd backwards, :func:`gather_to_rank0`,
:func:`broadcast_axes` and point-to-point :func:`send` / :func:`recv`.  Each
adds one to its kind's count and the bytes of its result to its kind's
bytes in :data:`COUNTERS` (HLO's convention, which the dry run's
``parse_collectives`` reads), and its wall time to ``COUNTERS["seconds"]``
and ``COUNTERS["seconds_by_kind"]``;
a collective over a group of one rank moves nothing and counts nothing.
Under gloo, CUDA tensors are staged through pinned host buffers (gloo's
collectives here take host tensors): the computation stays on the card.
"""

from __future__ import annotations

import functools
import math
import os
import time
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


# ---------------------------------------------------------------------------
# Subgroup collectives of the LM multi-device path, with counters
# ---------------------------------------------------------------------------

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
         "gather", "broadcast")
COUNTERS: dict = {}


def reset_counters() -> None:
    """Zero every kind's count and bytes, and the seconds."""
    COUNTERS.clear()
    COUNTERS.update({k: {"count": 0, "bytes": 0} for k in KINDS})
    COUNTERS["seconds"] = 0.0
    COUNTERS["seconds_by_kind"] = dict.fromkeys(KINDS, 0.0)


def counters() -> dict:
    """A copy of :data:`COUNTERS`: ``{kind: {"count", "bytes"}, "seconds",
    "seconds_by_kind"}``."""
    return {k: dict(v) if isinstance(v, dict) else v for k, v in COUNTERS.items()}


reset_counters()


def _count(kind: str, nbytes: int, t0: float) -> None:
    COUNTERS[kind]["count"] += 1
    COUNTERS[kind]["bytes"] += int(nbytes)
    dt = time.perf_counter() - t0
    COUNTERS["seconds"] += dt
    COUNTERS["seconds_by_kind"][kind] += dt


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


_GROUPS: dict = {}


def axis_group(mesh, axes: Sequence[str]):
    """(process group, its global ranks in row-major order over ``axes``)
    of the ranks along ``axes`` at this rank's coordinates on the other
    axes; ``(None, (rank,))`` where that is one rank.  The first call for
    an ``axes`` makes the groups of every coset, on every rank."""
    axes = tuple(a for a in mesh.mesh_dim_names if a in axes)
    ranks = _ranks_over(mesh, axes)
    if len(ranks) == 1:
        return None, ranks
    key = (tuple(mesh.mesh_dim_names), tuple(mesh.mesh.reshape(-1).tolist()),
           tuple(mesh.mesh.shape), axes)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        grid = mesh.mesh.permute([names.index(a) for a in names if a not in axes]
                                 + [names.index(a) for a in axes])
        cosets = grid.reshape(-1, len(ranks))
        made = {}
        for row in cosets.tolist():
            made[tuple(row)] = dist.new_group(row)
        _GROUPS[key] = made
    return _GROUPS[key][ranks], ranks


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the backend takes it: a pinned host copy of a CUDA tensor
    under gloo, else ``x`` itself (contiguous)."""
    x = x.contiguous()
    if x.device.type == "cuda" and dist.get_backend(group) != "nccl":
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host
    return x


def _empty_wire(like: torch.Tensor, group, shape=None) -> torch.Tensor:
    shape = like.shape if shape is None else shape
    if like.device.type == "cuda" and dist.get_backend(group) != "nccl":
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _gather_parts(x: torch.Tensor, group, ranks) -> list[torch.Tensor]:
    wire = _wire(x, group)
    out = _empty_wire(x, group, (len(ranks) * x.numel(),))
    dist.all_gather_into_tensor(out, wire.reshape(-1), group=group)
    return list(out.to(x.device).view((len(ranks),) + tuple(x.shape)).unbind(0))


def all_gather_axes(x: torch.Tensor, mesh, axes: Sequence[str]) -> list[torch.Tensor]:
    """Every rank's ``x`` along ``axes`` (row-major over them), on ``x``'s
    device; counted as one all-gather of the parts' bytes."""
    group, ranks = axis_group(mesh, axes)
    if group is None:
        return [x]
    t0 = time.perf_counter()
    parts = _gather_parts(x, group, ranks)
    _count("all-gather", _nbytes(x) * len(ranks), t0)
    return parts


def fold_axes(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """``psum`` over ``axes`` as a gather folded in row-major rank order:
    the same bits on every rank."""
    return _fold(all_gather_axes(x, mesh, axes))


# all_reduce's size from which a member folds 1/n of the elements
SPLIT_FOLD_BYTES = 1 << 20


def all_reduce(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """:func:`fold_axes` counted as what it stands for: one all-reduce of
    ``x``'s bytes (HLO's result bytes).  From ``SPLIT_FOLD_BYTES`` over
    three or more members, member j folds the j-th 1/n of the elements in
    member order (one all-to-all) and the folded parts are gathered: the
    same sums in the same order, so the same bits, with 2(n-1)/n of ``x``
    moved a rank instead of n-1."""
    group, ranks = axis_group(mesh, axes)
    if group is None:
        return x
    t0 = time.perf_counter()
    n = len(ranks)
    if n < 3 or _nbytes(x) < SPLIT_FOLD_BYTES:
        out = _fold(_gather_parts(x, group, ranks))
    else:
        flat = x.reshape(-1)
        per = -(-flat.numel() // n)
        send = torch.nn.functional.pad(flat, (0, per * n - flat.numel())).view(n, per)
        recv = _empty_wire(send, group)
        dist.all_to_all_single(recv, _wire(send, group), group=group)
        part = _fold(list(recv.to(x.device).unbind(0)))
        whole = _empty_wire(part, group, (n * per,))
        dist.all_gather_into_tensor(whole, _wire(part, group), group=group)
        out = whole[:flat.numel()].to(x.device).view(x.shape)
    _count("all-reduce", _nbytes(x), t0)
    return out


# -- Megatron's f and g over ``model`` (tensor parallelism) ----------------

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ("model",)), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh, ("model",))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(x, mesh, ("model",))

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ("model",)), None


def tp_copy(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's f at the entry of a tensor-parallel region: ``x`` (the
    same on every ``model`` rank) unchanged; backward folds the ranks'
    partial gradients over ``model`` in rank order."""
    return _Copy.apply(x, mesh)


def tp_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's g at its exit: the ranks' partial sums folded over
    ``model`` in rank order (the same bits on every rank); backward passes
    the gradient, the same on every rank, through."""
    return _Reduce.apply(x, mesh)


def tp_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """A sum over ``model`` whose result each rank reads with its own block
    (a norm's sum of squares over a split width): folded both ways."""
    return _Sum.apply(x, mesh)


class _Relayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, src, dst, dst_dim):
        ctx.mesh, ctx.dim, ctx.src, ctx.dst, ctx.dst_dim = mesh, dim, src, dst, dst_dim
        return _relayout(x, mesh, dim, src, dst, dst_dim)

    @staticmethod
    def backward(ctx, g):
        return (_relayout(g, ctx.mesh, ctx.dst_dim, ctx.dst, ctx.src, ctx.dim),
                None, None, None, None, None)


def _relayout(x, mesh, dim, src, dst, dst_dim):
    parts = all_gather_axes(x, mesh, ("model",))
    whole = torch.cat(parts, dim=dim)
    order = torch.tensor([i for block in src for i in block], device=x.device)
    full = torch.empty_like(whole).index_copy_(dim, order, whole)
    me = axis_index(mesh, ("model",))
    return full.index_select(dst_dim, torch.tensor(dst[me], device=x.device))


def relayout(x: torch.Tensor, mesh, dim: int, src: tuple, dst: tuple,
             dst_dim: int | None = None) -> torch.Tensor:
    """This rank's block of a dim split over ``model`` in another layout:
    ``src[r]`` are the indices along ``dim`` that rank r holds before,
    ``dst[r]`` those along ``dst_dim`` (``dim`` by default) it holds after,
    each index held once in each (a ``dst_dim`` of its own moves the split
    from one dim to another: the heads' blocks to the sequence's).  One
    all-gather over ``model``; backward is the inverse relayout of the
    gradient."""
    return _Relayout.apply(x, mesh, dim, src, dst, dim if dst_dim is None else dst_dim)


def merge_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, mesh,
                   axes: Sequence[str]) -> torch.Tensor:
    """Flash-decoding's merge: each rank's softmax partials over its block
    of the keys, the row maximum ``m`` (..., 1), the sum of exponentials
    ``l`` (..., 1) and the unnormalised output ``o`` (..., D), all f32,
    gathered over ``axes`` (one all-gather) and merged in rank order:
    ``sum_r e^(m_r - M) o_r / sum_r e^(m_r - M) l_r`` with M the maximum."""
    parts = all_gather_axes(torch.cat([m, l, o], dim=-1), mesh, axes)
    top = parts[0][..., :1]
    for p in parts[1:]:
        top = torch.maximum(top, p[..., :1])
    num = den = None
    for p in parts:
        w = torch.exp(p[..., :1] - top)
        num = w * p[..., 2:] if num is None else num + w * p[..., 2:]
        den = w * p[..., 1:2] if den is None else den + w * p[..., 1:2]
    return num / den


def all_to_all_raw(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """``x`` (leading dim = the group's size): ``out[i]`` is member i's
    ``x[me]``.  One all-to-all of ``x``'s bytes."""
    group, ranks = axis_group(mesh, axes)
    if group is None:
        return x
    if x.shape[0] != len(ranks):
        raise ValueError(f"all_to_all: leading dim {x.shape[0]} != group size {len(ranks)}")
    t0 = time.perf_counter()
    wire = _wire(x, group)
    out = _empty_wire(x, group)
    dist.all_to_all_single(out, wire, group=group)
    out = out.to(x.device)
    _count("all-to-all", _nbytes(x), t0)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_to_all_raw(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        # the exchange is its own inverse: member i's piece for me came
        # from its x[me], so my gradient piece for i goes back to i
        return all_to_all_raw(g, ctx.mesh, ctx.axes), None, None


def all_to_all(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """:func:`all_to_all_raw` with an autograd backward (the same exchange
    of the gradient)."""
    return _AllToAll.apply(x, mesh, tuple(axes))


def _member_index(mesh, axes) -> int:
    return axis_index(mesh, tuple(a for a in mesh.mesh_dim_names if a in axes))


class _SliceAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        n = axis_size(mesh, axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
        return x.chunk(n, dim=dim)[_member_index(mesh, axes)].clone()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(all_gather_axes(g, ctx.mesh, ctx.axes), dim=ctx.dim), None, None, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim, ctx.n = mesh, axes, dim, x.shape[dim]
        return torch.cat(all_gather_axes(x, mesh, axes), dim=dim)

    @staticmethod
    def backward(ctx, g):
        i = _member_index(ctx.mesh, ctx.axes)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).clone(), None, None, None


def slice_along(x: torch.Tensor, mesh, axes: Sequence[str], dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` (replicated along ``axes``) along ``dim``,
    block = its index along ``axes``; backward all-gathers the blocks'
    gradients (the replicated input's gradient is every block's, the same
    on every rank)."""
    return _SliceAlong.apply(x, mesh, tuple(axes), dim)


def gather_along(x: torch.Tensor, mesh, axes: Sequence[str], dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``axes`` concatenated on ``dim`` (replicated
    after); backward takes this rank's block of the gradient, which every
    rank holds alike (the replicated result is used alike on each)."""
    return _GatherAlong.apply(x, mesh, tuple(axes), dim)


def reduce_scatter_fixed(g: torch.Tensor, mesh, sum_axes: Sequence[str],
                         pieces: list[tuple[slice, ...]]) -> torch.Tensor:
    """Deterministic reduce-scatter: ``pieces[j]`` is the block of ``g``
    that member j (row-major over ``sum_axes``) keeps; every member sends
    each its block (one all-to-all) and folds what it receives in member
    order.  Returns this rank's block of the sum; counted as one
    reduce-scatter of that block's bytes."""
    group, ranks = axis_group(mesh, sum_axes)
    if group is None:
        return g[pieces[0]].clone()
    t0 = time.perf_counter()
    send = torch.stack([g[p] for p in pieces])
    wire = _wire(send, group)
    recv = _empty_wire(send, group)
    dist.all_to_all_single(recv, wire, group=group)
    recv = recv.to(g.device)
    out = _fold(list(recv.unbind(0)))
    _count("reduce-scatter", _nbytes(out), t0)
    return out


def gather_to_rank0(x: torch.Tensor) -> list[torch.Tensor] | None:
    """Every rank's ``x`` on global rank 0 (in rank order), ``None``
    elsewhere; counted as one gather of the parts' bytes on every rank."""
    world = dist.get_world_size()
    t0 = time.perf_counter()
    wire = _wire(x, None)
    parts = [_empty_wire(x, None) for _ in range(world)] if dist.get_rank() == 0 else None
    dist.gather(wire, parts, dst=0)
    _count("gather", _nbytes(x) * world, t0)
    return parts


def broadcast_axes(x: torch.Tensor, mesh, axes: Sequence[str], src_index: int) -> torch.Tensor:
    """Member ``src_index``'s ``x`` (row-major over ``axes``) on every member."""
    group, ranks = axis_group(mesh, axes)
    if group is None:
        return x
    t0 = time.perf_counter()
    wire = _wire(x, group)
    dist.broadcast(wire, src=ranks[src_index], group=group)
    out = wire.to(x.device)
    _count("broadcast", _nbytes(x), t0)
    return out


def send(x: torch.Tensor, dst: int) -> None:
    """Point-to-point send to global rank ``dst`` (one collective-permute)."""
    t0 = time.perf_counter()
    dist.send(_wire(x, None), dst)
    _count("collective-permute", _nbytes(x), t0)


def recv(like: torch.Tensor, src: int) -> torch.Tensor:
    """Receive a tensor shaped as ``like`` from global rank ``src``."""
    buf = _empty_wire(like, None)
    dist.recv(buf, src)
    return buf.to(like.device)
