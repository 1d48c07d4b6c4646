"""Int8 quantisation with error feedback, and an int8 psum (port of
``repro.distributed.compression``).

Tensors are quantised to int8 with a per-tensor scale, and the
quantisation residual is fed back into the next step (error feedback
keeps the accumulated update unbiased, Karimireddy et al. 2019): 4x fewer
bytes on a data-parallel reduction.

* :func:`compress_tree` with :func:`init_error_tree`: quantise-dequantise
  with feedback over a dict (nested dicts allowed) or list of tensors;
* :func:`compressed_psum`: the explicit collective on a mesh axis, an
  int32 sum of int8 codes under one shared scale.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.tree import tree_map
from repro_torch.distributed import collectives


def quantize(x: torch.Tensor, *, bits: int = 8, amax: torch.Tensor | None = None):
    """Per-tensor symmetric quantisation: (q int8, scale f32 scalar).
    ``amax`` is the tensor's largest magnitude where ``x`` is one block of
    it (a sharded leaf: the blocks' maxima's maximum, which is exact)."""
    if amax is None:
        amax = torch.max(torch.abs(x)).to(torch.float32)
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(amax / qmax, min=1e-12)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale, dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def ef_compress(g: torch.Tensor, err: torch.Tensor, amax: torch.Tensor | None = None):
    """Error-feedback step: (g + err) -> (quantised ghat, new residual);
    ``amax`` as :func:`quantize` takes it."""
    target = g.to(torch.float32) + err
    q, scale = quantize(target, amax=amax)
    ghat = dequantize(q, scale)
    return ghat.to(g.dtype), target - ghat


def init_error_tree(params):
    """Zero f32 residuals shaped like every tensor of ``params`` (a dict,
    nested dicts allowed, or a list of tensors)."""
    if isinstance(params, (list, tuple)):
        return [init_error_tree(p) for p in params]
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_tree(grads, err_tree):
    """EF-int8 on every tensor of ``grads`` (a dict, nested dicts allowed,
    or a list of tensors): ``(ghat tree, new error tree)``."""
    if isinstance(grads, dict):
        out = {k: compress_tree(grads[k], err_tree[k]) for k in grads}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    if isinstance(grads, (list, tuple)):
        out = [compress_tree(g, e) for g, e in zip(grads, err_tree)]
        return [o[0] for o in out], [o[1] for o in out]
    return ef_compress(grads, err_tree)


def compressed_psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Int8-quantised psum over one mesh axis.

    Every shard quantises against the axis-wide largest scale (``pmax``),
    so the int8 codes add exactly as int32 (an ``all_reduce``: integer
    sums do not depend on the order), then dequantises.  Bytes on the
    wire: N int8 codes and one f32 per shard where a float psum sends N
    f32.  The error is at most half a code per shard: shards x scale / 2.
    """
    _, scale = quantize(x)
    smax = collectives.pmax(scale, mesh, (axis,))
    q = torch.clamp(torch.round(x.to(torch.float32) / smax), -127, 127)
    total = q.to(torch.int32)
    group = mesh.get_group(axis)
    if total.device.type == "cuda" and dist.get_backend(group) != "nccl":
        host = total.cpu()
        dist.all_reduce(host, group=group)
        total = host.to(x.device)
    else:
        dist.all_reduce(total, group=group)
    return (total.to(torch.float32) * smax).to(x.dtype)
