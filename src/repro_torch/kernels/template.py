"""The fused MC sample+eval+reduce kernel: dispatcher, CUDA wrapper and
plain PyTorch version (port of ``repro.kernels.template``).

One launch covers a padded stack of functions, ``F_BLK`` rows per block,
each block homogeneous in form.  Per function ``f``, sample ``s`` and dim
``d`` it draws ``c0 = sample_offset + s`` (u32 wrap) and
``c1 = fn_id * 256 + d``, turns Threefry-2x32 bits into a uniform, maps it
into the box, evaluates the block's body and returns per-function
``(sum f, sum f^2)`` over the samples below ``n_valid``.

* :func:`fused_mc` dispatches on the device of its tensors: CPU tensors
  go to :func:`fused_mc_plain`, CUDA tensors to :func:`fused_mc_cuda`
  (the hand-written kernel in ``csrc/fused_mc.cu``), anything else raises.
  There is no fallback from the kernel to the plain version.
* :func:`fused_mc_plain` computes the same thing in plain PyTorch, blocked
  over 2048-sample blocks whose sums are folded in order.
* A registered form (:class:`repro_torch.kernels.registry.KernelForm`)
  supplies a body and a packer; :func:`make_family_impl` turns it into a
  single-family impl, ``mc_eval.multi`` into one launch per dim bucket.

Operands (as ``repro``'s ``fused_mc_pallas``): ``scalars`` u32[4]
``(k0, k1, sample_offset, n_valid)`` and ``block_forms`` i32[n_pad / 16]
(the form id of each block) are host metadata and stay on the CPU;
``fn_ids`` u32[n_pad] (int64 holding u32 values, or int32 bit patterns),
``packed`` f32[n_pad, n_cols] and ``lo``/``hi`` f32[n_pad, dim] live on the
device that runs the launch.  The result is f32[1, n_pad, 2].
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import rng

# Functions per block and samples per sample block (repro's tile).
F_BLK = 16
S_BLK = 2048
# Samples per CUDA block in pass 1 (csrc/fused_mc.cu CHUNK_SAMPLES).
CHUNK_SAMPLES = 8 * S_BLK
# Elements (rows x samples x dims) the plain version draws per step.
_PLAIN_STEP_ELEMS = 1 << 24

# Fused dispatches on either device, as repro's launch counter.
_LAUNCHES = 0
# Launches of the CUDA kernel only (fused_mc_cuda).
_KERNEL_LAUNCHES = 0


def record_launch() -> None:
    global _LAUNCHES
    _LAUNCHES += 1


def launch_count() -> int:
    return _LAUNCHES


def reset_launch_count() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def kernel_launch_count() -> int:
    """Launches of the CUDA kernel since the last reset."""
    return _KERNEL_LAUNCHES


def reset_kernel_launch_count() -> None:
    global _KERNEL_LAUNCHES
    _KERNEL_LAUNCHES = 0


def pad_rows(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Zero-pad the leading (function) axis by ``n_pad`` rows."""
    if n_pad == 0:
        return x
    return F.pad(x, [0, 0] * (x.ndim - 1) + [0, n_pad])


def pack_scalars(key, sample_offset, n_samples) -> torch.Tensor:
    """int64 CPU tensor of the u32 words (k0, k1, sample_offset, n_valid)."""
    return torch.tensor([int(key[0]), int(key[1]), int(sample_offset),
                         int(n_samples)], dtype=torch.int64) & rng.MASK32


def packed_cols(form, family) -> int:
    """Packed width of ``family`` under ``form`` (plain families only)."""
    return form.n_cols(family.dim)


def body_and_packed(form, family):
    """The (eval body, f32[n_fn, n_cols]) pair of one plain family."""
    return form.body, form.pack_params(family).to(torch.float32)


def _check_operands(scalars, fn_ids, packed, lo, hi, block_forms, dim):
    n_pad = fn_ids.shape[0]
    if fn_ids.ndim != 1 or n_pad == 0 or n_pad % F_BLK:
        raise ValueError(f"fn_ids must be 1-d with a positive multiple of "
                         f"{F_BLK} rows; got {tuple(fn_ids.shape)}")
    if packed.ndim != 2 or packed.shape[0] != n_pad:
        raise ValueError(f"packed must be ({n_pad}, n_cols); got "
                         f"{tuple(packed.shape)}")
    for name, t in (("lo", lo), ("hi", hi)):
        if tuple(t.shape) != (n_pad, dim):
            raise ValueError(f"{name} must be ({n_pad}, {dim}); got "
                             f"{tuple(t.shape)}")
    for name, t in (("packed", packed), ("lo", lo), ("hi", hi)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {t.dtype}")
    for name, t in (("fn_ids", fn_ids), ("lo", lo), ("hi", hi)):
        if t.device != packed.device:
            raise ValueError(f"{name} is on {t.device}, packed on "
                             f"{packed.device}")
    if fn_ids.dtype not in (torch.int64, torch.int32, torch.uint32):
        raise TypeError(f"fn_ids must hold u32 values; got {fn_ids.dtype}")
    for name, t in (("scalars", scalars), ("block_forms", block_forms)):
        if t.device.type != "cpu":
            raise ValueError(f"{name} is host metadata and must be a CPU "
                             f"tensor; got {t.device}")
    if tuple(scalars.shape) != (4,):
        raise ValueError(f"scalars must be u32[4]; got {tuple(scalars.shape)}")
    if tuple(block_forms.shape) != (n_pad // F_BLK,):
        raise ValueError(f"block_forms must be ({n_pad // F_BLK},); got "
                         f"{tuple(block_forms.shape)}")
    if dim < 1:
        raise ValueError(f"dim must be >= 1; got {dim}")


def fused_mc(scalars, fn_ids, packed, lo, hi, block_forms, *, dim: int,
             n_sample_blocks: int) -> torch.Tensor:
    """One fused launch: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; raises on any other device."""
    record_launch()
    kind = packed.device.type
    if kind == "cuda":
        return fused_mc_cuda(scalars, fn_ids, packed, lo, hi, block_forms,
                             dim=dim, n_sample_blocks=n_sample_blocks)
    if kind == "cpu":
        return fused_mc_plain(scalars, fn_ids, packed, lo, hi, block_forms,
                              dim=dim, n_sample_blocks=n_sample_blocks)
    raise ValueError(f"fused_mc runs on 'cuda' or 'cpu' tensors; got {kind!r}")


def fused_mc_plain(scalars, fn_ids, packed, lo, hi, block_forms, *, dim: int,
                   n_sample_blocks: int) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel, on the tensors' device.

    Draws whole 2048-sample blocks (several per step, bounded by
    ``_PLAIN_STEP_ELEMS``), evaluates each form's body on its rows, and
    folds the per-block sums in block order.
    """
    from repro_torch.kernels import registry
    _check_operands(scalars, fn_ids, packed, lo, hi, block_forms, dim)
    k0, k1, offset, n_valid = (int(v) for v in scalars.tolist())
    device = packed.device
    n_pad = fn_ids.shape[0]
    c1 = rng.counter_c1(rng.as_u32(fn_ids)[:, None],
                        torch.arange(dim, dtype=torch.int64, device=device))
    width = hi - lo
    row_forms = np.repeat(block_forms.numpy().astype(np.int64), F_BLK)
    groups = [(registry.by_id(f).body,
               torch.from_numpy(np.flatnonzero(row_forms == f)).to(device))
              for f in np.unique(row_forms)]
    step = max(1, min(n_sample_blocks,
                      _PLAIN_STEP_ELEMS // (n_pad * S_BLK * dim)))
    acc = torch.zeros(n_pad, 2, dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    for j0 in range(0, n_sample_blocks, step):
        k = min(step, n_sample_blocks - j0)
        local = j0 * S_BLK + torch.arange(k * S_BLK, dtype=torch.int64,
                                          device=device)
        c0 = (offset + local) & rng.MASK32
        u = rng.bits_to_uniform(
            rng.random_bits(k0, k1, c0[None, :, None], c1[:, None, :]))
        x = lo[:, None, :] + u * width[:, None, :]
        vals = torch.empty(n_pad, k * S_BLK, dtype=torch.float32,
                           device=device)
        for body, rows in groups:
            xr = x[rows]
            vals[rows] = body(lambda d, xr=xr: xr[:, :, d], packed[rows], dim)
        vals = torch.where(local[None, :] < n_valid, vals, zero)
        vals = vals.view(n_pad, k, S_BLK)
        part = torch.stack([vals.sum(-1), (vals * vals).sum(-1)], dim=-1)
        for i in range(k):
            acc = acc + part[:, i]
    return acc[None]


def fused_mc_cuda(scalars, fn_ids, packed, lo, hi, block_forms, *, dim: int,
                  n_sample_blocks: int) -> torch.Tensor:
    """Launch the CUDA kernel (``csrc/fused_mc.cu``) on the current stream.

    Checks device, dtype, shape and contiguity, allocates the output and
    the pass-1 scratch, and raises if the launch reports a CUDA error.
    """
    global _KERNEL_LAUNCHES
    from repro_torch.kernels import build
    _check_operands(scalars, fn_ids, packed, lo, hi, block_forms, dim)
    device = packed.device
    if device.type != "cuda":
        raise ValueError(f"fused_mc_cuda needs CUDA tensors; got {device}")
    for name, t in (("packed", packed), ("lo", lo), ("hi", hi)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = build.load("zmc_fused_mc")
    if lib.zmc_chunk_samples() != CHUNK_SAMPLES:
        raise RuntimeError("csrc/fused_mc.cu CHUNK_SAMPLES disagrees with "
                           "template.CHUNK_SAMPLES")
    k0, k1, offset, n_valid = (int(v) for v in scalars.tolist())
    n_pad, n_cols = packed.shape
    n_eff = min(n_valid, n_sample_blocks * S_BLK)
    n_chunks = max(1, math.ceil(n_eff / CHUNK_SAMPLES))
    fid = rng.u32_bits(rng.as_u32(fn_ids)).contiguous()
    forms = block_forms.to(torch.int32).to(device).contiguous()
    scratch = torch.empty(n_pad, n_chunks, 2, dtype=torch.float32,
                          device=device)
    out = torch.empty(1, n_pad, 2, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.zmc_fused_mc(k0, k1, offset, n_eff, fid.data_ptr(),
                               forms.data_ptr(), packed.data_ptr(), n_cols,
                               lo.data_ptr(), hi.data_ptr(), dim, n_pad,
                               n_chunks, scratch.data_ptr(), out.data_ptr(),
                               stream)
    if err != 0:
        raise RuntimeError(f"zmc_fused_mc launch failed with CUDA error {err}")
    _KERNEL_LAUNCHES += 1
    return out


def random_bits_cuda(k0: int, k1: int, c0: torch.Tensor,
                     c1: torch.Tensor) -> torch.Tensor:
    """``rng.random_bits`` computed by the device header's Threefry
    (test-only kernel; nothing on the main path calls it).  ``c0``/``c1``
    hold u32 values on one CUDA device; returns int64 u32 values."""
    from repro_torch.kernels import build
    if c0.device.type != "cuda" or c1.device != c0.device:
        raise ValueError("random_bits_cuda needs c0 and c1 on one CUDA device")
    if c0.shape != c1.shape:
        raise ValueError(f"c0 {tuple(c0.shape)} and c1 {tuple(c1.shape)} differ")
    lib = build.load("zmc_fused_mc")
    a = rng.u32_bits(rng.as_u32(c0)).contiguous()
    b = rng.u32_bits(rng.as_u32(c1)).contiguous()
    out = torch.empty_like(a)
    with torch.cuda.device(c0.device):
        stream = torch.cuda.current_stream(c0.device).cuda_stream
        err = lib.zmc_random_bits(int(k0) & rng.MASK32, int(k1) & rng.MASK32,
                                  a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  a.numel(), stream)
    if err != 0:
        raise RuntimeError(f"zmc_random_bits launch failed with CUDA error {err}")
    return rng.as_u32(out)


def make_family_impl(form):
    """Single-family impl of one form: pads the family to ``F_BLK`` rows
    and makes one :func:`fused_mc` launch."""
    from repro_torch.core.direct_mc import SumsState, n_tensor

    def impl(family, n_samples: int, key, *, fn_offset: int = 0,
             sample_offset=0, fn_ids=None) -> SumsState:
        n_fn, dim = family.n_fn, family.dim
        if not form.supports(dim=dim):
            raise ValueError(f"kernel {form.name!r} does not support dim={dim}")
        device = family.device
        if fn_ids is None:
            fn_ids = fn_offset + torch.arange(n_fn, dtype=torch.int64,
                                              device=device)
        pad = math.ceil(n_fn / F_BLK) * F_BLK - n_fn
        _, packed = body_and_packed(form, family)
        out = fused_mc(
            pack_scalars(key, sample_offset, n_samples),
            pad_rows(rng.as_u32(fn_ids, device), pad),
            pad_rows(packed, pad).contiguous(),
            pad_rows(family.domains[..., 0], pad).contiguous(),
            pad_rows(family.domains[..., 1], pad).contiguous(),
            torch.full(((n_fn + pad) // F_BLK,), form.form_id,
                       dtype=torch.int32),
            dim=dim, n_sample_blocks=max(1, math.ceil(int(n_samples) / S_BLK)))[0]
        return SumsState(s1=out[:n_fn, 0], s2=out[:n_fn, 1],
                         n=n_tensor(n_samples, device))

    impl.__name__ = form.name
    impl.form = form
    return impl
