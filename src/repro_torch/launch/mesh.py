"""Meshes for multi-device runs (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group, with ``repro``'s axis names and order:
``("data", "model")``, or ``("pod", "data", "model")`` across pods.
Functions shard over ``"model"``, samples over the other axes.  Each rank
is one process (start them with torchrun, or with
:func:`repro_torch.launch.multihost.spawn`) and computes on its own card,
``LOCAL_RANK % torch.cuda.device_count()``, on a ``"cuda"`` mesh.
Nothing here runs at import.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device
from repro_torch.distributed import collectives


def _world(device) -> tuple[str, int]:
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialised: start the ranks with "
            "torchrun or repro_torch.launch.multihost.spawn, or call "
            "multihost.initialize_if_needed() first")
    kind = resolve_device(device).type
    if kind == "cpu" and dist.get_backend() == "nccl":
        raise ValueError("a 'cpu' mesh needs a gloo process group; this one "
                         "is NCCL")
    return kind, dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 ``("data", "model")`` per pod, 2 x 16 x 16 across pods.
    The mesh spans the process group, so the world must hold exactly
    that many ranks; raises otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    kind, world = _world(device)
    n = math.prod(shape)
    if world != n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}; have {world}")
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_mesh_for(n_devices: int | None = None, model_parallel: int = 1,
                  pods: int = 1, *, device=None):
    """A ``(data, model)`` mesh, or ``(pod, data, model)`` with ``pods >
    1``, over ``n_devices`` ranks (default: the world, which the mesh must
    span).  ``device`` picks the mesh's device type as the entry points'
    ``device`` does (default ``"cuda"``)."""
    kind, world = _world(device)
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"the mesh must span the process group: "
                         f"n_devices={n}, world size {world}")
    if n % (model_parallel * pods):
        raise ValueError(f"{n} devices not divisible by "
                         f"model={model_parallel} x pods={pods}")
    data = n // (model_parallel * pods)
    if pods > 1:
        return init_device_mesh(kind, (pods, data, model_parallel),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(kind, (data, model_parallel),
                            mesh_dim_names=("data", "model"))


def launcher_mesh(device=None):
    """The integrators' and the trainer's ``--mesh``: every rank, 2
    ``model`` shards when the world is even and larger than 1 (the
    functions, or the parameters' model dims), the rest over ``data``."""
    _, world = _world(device)
    return make_mesh_for(model_parallel=2 if world % 2 == 0 and world > 1 else 1,
                         device=device)


def mesh_info(mesh) -> dict:
    shape = collectives.mesh_shape(mesh)
    return {"axis_names": tuple(shape), "shape": shape,
            "n_devices": mesh.size()}
