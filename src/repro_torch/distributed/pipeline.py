"""GPipe-style pipeline parallelism over a mesh axis (port of
``repro.distributed.pipeline``).

Maps a stack of identical stages onto the ``pod`` (or any) mesh axis and
streams microbatches through: activations cross the axis once per stage
boundary instead of gradients crossing it once per step, the right trade
when ``activation_bytes * microbatches < grad_bytes``.

The reference's single-program schedule: every rank runs the same loop of
``M + P - 1`` ticks; at tick t, stage p works on microbatch ``t - p`` (when
that is one) and sends its output to stage p+1 (``send`` / ``recv``,
point-to-point).  Bubble fraction = (P-1)/(M+P-1).  Only the last stage
holds the outputs; they are broadcast from its rank along the axis, which
gives the bits the reference's masked ``psum`` gives (its other terms are
zeros).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, mesh,
                   axis: str = "pod", *, timings: dict | None = None) -> torch.Tensor:
    """Run ``x`` (M, mb, ...) through the stages of ``stage_fn`` pipelined
    over ``axis``; returns the (M, mb, ...) outputs on every rank.

    ``stage_params`` is this rank's stage: a tree whose leaves carry a
    leading stage axis, either whole (n_stages, ...) or this rank's block
    of it (1, ...) as the reference's spec ``P(axis)`` places it.
    ``stage_fn(params, x_mb) -> y_mb`` keeps the shape and dtype.
    ``timings`` (a dict) receives ``busy`` (seconds in ``stage_fn``) and
    ``wall``."""
    n_stages = sh.mesh_axes(mesh)[axis]
    m = x.shape[0]
    p = collectives.axis_index(mesh, (axis,))
    _, ranks = collectives.axis_group(mesh, (axis,))

    def mine(leaf):
        if isinstance(leaf, dict):
            return {k: mine(v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(mine(v) for v in leaf)
        return leaf[p] if leaf.shape[0] == n_stages else leaf[0]

    params = mine(stage_params)
    outputs = torch.zeros_like(x)
    busy, t0 = 0.0, time.perf_counter()
    for t in range(m + n_stages - 1):
        mb = t - p
        if not 0 <= mb < m:
            continue
        inp = x[mb] if p == 0 else collectives.recv(x[0], ranks[p - 1])
        t1 = time.perf_counter()
        out = stage_fn(params, inp)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        busy += time.perf_counter() - t1
        if p == n_stages - 1:
            outputs[mb] = out
        else:
            collectives.send(out, ranks[p + 1])
    outputs = collectives.broadcast_axes(outputs, mesh, (axis,), n_stages - 1)
    if timings is not None:
        timings.update(busy=busy, wall=time.perf_counter() - t0)
    return outputs
