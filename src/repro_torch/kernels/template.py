"""The fused MC sample+eval+reduce kernel: dispatcher, CUDA wrapper and
plain PyTorch version (port of ``repro.kernels.template``).

One launch covers a padded stack of functions, ``F_BLK`` rows per block,
each block homogeneous in form, and ``n_rounds`` consecutive counter
windows.  Per function ``f``, round ``r``, sample ``s`` and dim ``d`` it
takes ``c0 = sample_offset + round_base[block] + r * round_stride + s``
(u32 wrap) and ``c1 = fn_id * 256 + d`` and draws a uniform: with
``sampler="mc"`` from the Threefry-2x32 bits of ``(c0, c1)``, with
``sampler="sobol"`` from the Sobol point of index ``c0`` (shared by the
block's functions) XOR the digital shift ``random_bits(k0, k1, 0x50B01,
c1)``.  It maps the uniform into the box, evaluates the block's body
(wrapped in the compactification stage in a compactified block, on the
block's packed rows with its sweep table columns substituted in a swept
block, and, in an adapted block, at the points the block's importance
grid maps the uniforms to) and returns per-round, per-function ``(sum f, sum f^2)`` over the
samples below ``n_valid``.  Round ``r`` of an R-round launch equals a
single-round launch at that round's offset, bit for bit.

* :func:`fused_mc` dispatches on the device of its tensors: CPU tensors
  go to :func:`fused_mc_plain`, CUDA tensors to :func:`fused_mc_cuda`
  (the hand-written kernel in ``csrc/fused_mc.cu``), anything else raises.
  There is no fallback from the kernel to the plain version.
* :func:`fused_mc_plain` computes the same thing in plain PyTorch, round
  by round, blocked over 2048-sample blocks whose sums are folded in
  order.
* A registered form (:class:`repro_torch.kernels.registry.KernelForm`)
  supplies a body and a packer; :func:`make_family_impl` turns it into a
  single-family impl, ``mc_eval.multi`` into one launch per dim bucket.
* :func:`body_and_packed` is the one place a swept family grows its
  table columns, an adapted one its grid edges and a compactified one its
  transform columns, in ``repro``'s row order
  ``[base][sweep][adapt][kind_0..kind_{dim-1}][shift_0..]``.

Operands (as ``repro``'s ``fused_mc_pallas``): ``scalars`` u32[4]
``(k0, k1, sample_offset, n_valid)`` or u32[5] with ``round_stride``
appended, ``block_forms`` i32[n_pad / 16] (the form id of each block),
``block_tcols`` i32[n_pad / 16] (-1 for a plain block, else the first
transform column of a compactified one), ``block_sweep`` i32[2 * S,
n_pad / 16] (row ``2j`` the base column that the column of row ``2j + 1``
overrides in a swept block, -1 where a block has fewer than ``S``
pairs), ``block_adapt`` i32[2, n_pad / 16] (row 0 -1 for an unadapted
block, else the first grid-edge column of an adapted one; row 1 its bins
per axis) and ``round_base`` u32[n_pad / 16] are host metadata and stay
on the CPU (u32 values as int64);
``fn_ids`` u32[n_pad] (int64 holding u32 values, or int32 bit patterns),
``packed`` f32[n_pad, n_cols] and ``lo``/``hi`` f32[n_pad, dim] live on
the device that runs the launch.  The result is f32[n_rounds, n_pad, 2].
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import domains as domains_lib
from repro_torch.core import rng, sobol

# Functions per block and samples per sample block (repro's tile).
F_BLK = 16
S_BLK = 2048
# Samples per CUDA block in pass 1 (csrc/fused_mc.cu CHUNK_SAMPLES).
CHUNK_SAMPLES = 8 * S_BLK
# Elements (rows x samples x dims) the plain version draws per step.
_PLAIN_STEP_ELEMS = 1 << 24

# Launch counters.  The service launches from its worker thread while
# other threads read and reset them, so every update holds the lock.
_COUNT_LOCK = threading.Lock()
# Fused dispatches on either device, as repro's launch counter.
_LAUNCHES = 0
# Launches of the CUDA kernel (fused_mc_cuda) by the variant they ran:
# "fused_mc" (one round) and "fused_mc_rounds" (n_rounds > 1) split them;
# "fused_mc_compactified" and "fused_mc_swept" count those that held at
# least one compactified, swept or adapted block, "fused_mc_sobol" those
# that drew Sobol points.
VARIANTS = ("fused_mc", "fused_mc_rounds", "fused_mc_compactified",
            "fused_mc_sobol", "fused_mc_swept", "fused_mc_adapted")
_VARIANT_LAUNCHES = dict.fromkeys(VARIANTS, 0)


def record_launch() -> None:
    global _LAUNCHES
    with _COUNT_LOCK:
        _LAUNCHES += 1


def launch_count() -> int:
    return _LAUNCHES


def reset_launch_count() -> None:
    global _LAUNCHES
    with _COUNT_LOCK:
        _LAUNCHES = 0


def kernel_launch_count() -> int:
    """Launches of the CUDA kernel since the last reset."""
    with _COUNT_LOCK:
        return (_VARIANT_LAUNCHES["fused_mc"]
                + _VARIANT_LAUNCHES["fused_mc_rounds"])


def kernel_launch_counts() -> dict[str, int]:
    """CUDA kernel launches by variant (see ``VARIANTS``) since the last
    reset."""
    with _COUNT_LOCK:
        return dict(_VARIANT_LAUNCHES)


def reset_kernel_launch_count() -> None:
    """Zero the CUDA kernel's per-variant launch counts."""
    with _COUNT_LOCK:
        _VARIANT_LAUNCHES.update(dict.fromkeys(VARIANTS, 0))


def pad_rows(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Zero-pad the leading (function) axis by ``n_pad`` rows."""
    if n_pad == 0:
        return x
    return F.pad(x, [0, 0] * (x.ndim - 1) + [0, n_pad])


def pack_scalars(key, sample_offset, n_samples, round_stride=None) -> torch.Tensor:
    """int64 CPU tensor of the u32 words (k0, k1, sample_offset, n_valid),
    with ``round_stride`` appended for a multi-round launch."""
    words = [int(key[0]), int(key[1]), int(sample_offset), int(n_samples)]
    if round_stride is not None:
        words.append(int(round_stride))
    return torch.tensor(words, dtype=torch.int64) & rng.MASK32


def probe_operands(dim: int, n_cols: int, device="cpu"):
    """Zero-filled operands for one eval body, shaped exactly like what
    :func:`fused_mc_plain` hands a body for one block: ``draws`` is
    f32[dim, F_BLK, S_BLK] (``draws[d]`` is dimension ``d``'s samples of
    the block's functions, what ``draw(d)`` returns) and ``packed`` the
    f32[F_BLK, n_cols] parameter block.  The contract checker
    (:mod:`repro_torch.analysis.contracts`) runs bodies on them without a
    card or a kernel; ``device="meta"`` gives the same shapes without
    data.
    """
    return (torch.zeros((dim, F_BLK, S_BLK), dtype=torch.float32, device=device),
            torch.zeros((F_BLK, n_cols), dtype=torch.float32, device=device))


def compactified_body(body, base_cols: int):
    """Wrap an eval body with the compactification stage (plain version
    of the CUDA kernel's compactified blocks).

    A compactified family's packed row carries, after its form's
    ``base_cols`` columns, ``[kind_0..kind_{dim-1}, shift_0..shift_{dim-1}]``.
    The wrapper maps each dimension's draw through
    :func:`repro_torch.core.domains.apply_transform`, hands the body the
    mapped draws, and multiplies its value by the Jacobian product.
    """

    def wrapped(draw, p, dim: int):
        xs = []
        jac = None
        for d in range(dim):
            x, j = domains_lib.apply_transform(
                draw(d), p[:, base_cols + d:base_cols + d + 1],
                p[:, base_cols + dim + d:base_cols + dim + d + 1])
            xs.append(x)
            jac = j if jac is None else jac * j
        return body(lambda d: xs[d], p, dim) * jac

    wrapped.__name__ = f"compactified_{getattr(body, '__name__', 'body')}"
    return wrapped


def transform_cols(family) -> torch.Tensor:
    """f32[n_fn, 2 * dim] packed (kind, shift) columns of a compactified
    family, appended after its form's own parameter columns."""
    aux = family.params["aux"]
    return torch.cat([aux["kind"].to(torch.float32),
                      aux["shift"].to(torch.float32)], dim=1)


def adapted_body(body, acol: int, n_bins: int):
    """Wrap an eval body with the VEGAS importance-map stage (plain
    version of the CUDA kernel's adapted blocks).

    An adapted family's packed row carries, from column ``acol``,
    ``dim * (n_bins + 1)`` bin edges, axis-major.  Per axis the wrapper
    takes the draw ``u`` (the box is the unit cube), picks the bin
    ``idx = min(int(u * n_bins), n_bins - 1)``, interpolates linearly
    between its edges, hands the body the mapped points and multiplies
    its value by the Jacobian ``prod_d n_bins * (e1 - e0)``, as
    ``repro``'s ``adapted_body`` does.
    """

    def wrapped(draw, p, dim: int):
        xs = []
        jac = None
        for d in range(dim):
            col = acol + d * (n_bins + 1)
            u = draw(d)
            s = u * float(n_bins)
            idx = torch.clamp(s.to(torch.int64), max=n_bins - 1)
            e = p[:, col:col + n_bins + 1]
            e0 = torch.gather(e, 1, idx)
            e1 = torch.gather(e, 1, idx + 1)
            xs.append(e0 + (s - idx.to(torch.float32)) * (e1 - e0))
            w = (e1 - e0) * float(n_bins)
            jac = w if jac is None else jac * w
        return body(lambda d: xs[d], p, dim) * jac

    wrapped.__name__ = f"adapted_{getattr(body, '__name__', 'body')}"
    return wrapped


def adapt_grid_cols(family) -> torch.Tensor:
    """f32[n_fn, dim * (n_bins + 1)] packed bin edges of an adapted
    family, axis-major, after its form's base (and sweep) columns."""
    return family.params["grid"].to(torch.float32).reshape(family.n_fn, -1)


def swept_body(body, base_cols: int, col_map: tuple):
    """Wrap an eval body with the parameter-sweep substitution stage
    (plain version of the CUDA kernel's swept blocks).

    A swept family's packed row carries, after its form's ``base_cols``
    columns, one table column per swept parameter column; ``col_map[j]``
    names the base column that table column ``j`` overrides
    (:func:`sweep_col_map`).  The wrapper hands the body the row with
    those base columns replaced, so the body reads exactly what it reads
    for the same point packed as its own family.
    """
    dst = list(col_map)

    def wrapped(draw, p, dim: int):
        q = p.clone()
        q[:, dst] = p[:, base_cols:base_cols + len(dst)]
        return body(draw, q, dim)

    wrapped.__name__ = f"swept_{getattr(body, '__name__', 'body')}"
    return wrapped


def sweep_col_map(form, family) -> tuple:
    """Base-column substitution map of a swept ``family`` (its
    :meth:`~IntegrandFamily.inner` view) under ``form``: entry ``j`` is
    the base packed column that sweep table column ``j`` overrides.
    Table columns go name-major in ``family.swept`` order, each name
    contributing its ``form.sweep_cols(dim)`` columns in order.  Raises
    if the form cannot sweep a name or a table leaf's width disagrees
    with the form's columns."""
    if form.sweep_cols is None:
        raise ValueError(
            f"kernel form {form.name!r} does not support swept families")
    cols = form.sweep_cols(family.dim)
    table = family.params["table"]
    out = []
    for name in family.swept:
        if name not in cols:
            raise ValueError(
                f"kernel form {form.name!r} cannot sweep parameter "
                f"{name!r} at dim={family.dim}; sweepable: {sorted(cols)}")
        width = math.prod(int(s) for s in table[name].shape[1:])
        if width != len(cols[name]):
            raise ValueError(
                f"sweep axis {name!r} packs {width} column(s) per point "
                f"but form {form.name!r} maps it to {len(cols[name])} "
                f"base column(s) at dim={family.dim}")
        out.extend(int(c) for c in cols[name])
    return tuple(out)


def sweep_table_cols(family) -> torch.Tensor:
    """f32[n_fn, n_sweep_cols] packed per-point table columns of a swept
    family (its inner view), in :func:`sweep_col_map` order."""
    table = family.params["table"]
    return torch.cat([table[name].to(torch.float32).reshape(family.n_fn, -1)
                      for name in family.swept], dim=1)


def packed_cols(form, family) -> int:
    """Packed width of ``family`` under ``form``: base, sweep table, grid
    edge and transform columns."""
    sweep = len(sweep_col_map(form, family.inner())) if family.swept else 0
    adapt = family.dim * (family.adapt_bins + 1) if family.adapt_bins else 0
    return (form.n_cols(family.dim) + sweep + adapt
            + (2 * family.dim if family.compact else 0))


def adapt_col(form, family) -> tuple[int, int]:
    """(first grid-edge column, bins per axis) of ``family``'s packed
    rows, or (-1, 0) when it is not adapted (the per-block
    ``block_adapt`` values)."""
    if not family.adapt_bins:
        return -1, 0
    sweep = len(sweep_col_map(form, family.inner())) if family.swept else 0
    return form.n_cols(family.dim) + sweep, family.adapt_bins


def block_adapt_tensor(per_block) -> torch.Tensor:
    """i32[2, n_blocks] ``block_adapt`` from each block's
    :func:`adapt_col` pair."""
    return torch.tensor(per_block, dtype=torch.int32).reshape(-1, 2).T.contiguous()


def transform_col(form, family) -> int:
    """First transform column of ``family``'s packed rows, or -1 when it
    is not compactified (the per-block ``block_tcols`` value)."""
    if not family.compact:
        return -1
    return packed_cols(form, family) - 2 * family.dim


def sweep_pairs(form, family) -> tuple:
    """The ``(base column, table column)`` pairs of a swept family's
    packed rows (the per-block ``block_sweep`` entries); () otherwise."""
    if not family.swept:
        return ()
    base = form.n_cols(family.dim)
    return tuple((c, base + j)
                 for j, c in enumerate(sweep_col_map(form, family.inner())))


def block_sweep_tensor(pairs_per_block) -> torch.Tensor:
    """i32[2 * S, n_blocks] ``block_sweep`` from each block's pairs, S the
    most pairs of any block; -1 fills the rest."""
    width = max((len(p) for p in pairs_per_block), default=0)
    out = np.full((2 * width, len(pairs_per_block)), -1, np.int32)
    for b, pairs in enumerate(pairs_per_block):
        for j, (dst, src) in enumerate(pairs):
            out[2 * j, b], out[2 * j + 1, b] = dst, src
    return torch.from_numpy(out)


def body_and_packed(form, family):
    """The (plain eval body, f32[n_fn, cols]) pair of one family.

    A swept family gets the :func:`swept_body` wrapper and its table
    columns, a compactified one the :func:`compactified_body` wrapper and
    its transform columns, an adapted one the :func:`adapted_body`
    wrapper and its grid edges, composed as
    ``adapted_body(compactified_body(swept_body(body)))`` over
    ``[base][sweep][adapt][transform]`` (``repro``'s order); others pass
    through.  Callers must have checked ``form.supports(...,
    compactified=family.compact, sweep=family.swept,
    adapted=bool(family.adapt_bins))``.
    """
    core = family.adapt_inner()
    inner = core.inner()
    base_cols = form.n_cols(family.dim)
    body = form.body
    packed = form.pack_params(inner.sweep_base()).to(torch.float32)
    if family.swept:
        col_map = sweep_col_map(form, inner)
        body = swept_body(body, base_cols, col_map)
        packed = torch.cat([packed, sweep_table_cols(inner)], dim=1)
    acol, n_bins = adapt_col(form, family)
    if family.compact:
        # the transform columns sit after the grid edges: [..][adapt][transform]
        tcol = packed.shape[1] + (family.dim * (n_bins + 1) if n_bins else 0)
        body = compactified_body(body, tcol)
    if n_bins:
        body = adapted_body(body, acol, n_bins)
        packed = torch.cat([packed, adapt_grid_cols(family)], dim=1)
    if family.compact:
        packed = torch.cat([packed, transform_cols(core)], dim=1)
    return body, packed


def to_card(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` (CPU) on ``device`` without waiting for the card: a CUDA
    copy goes through pinned memory, since a copy from pageable memory
    first waits for all the work already queued on the stream."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _host_meta(name, t, n_blocks):
    if t.device.type != "cpu":
        raise ValueError(f"{name} is host metadata and must be a CPU "
                         f"tensor; got {t.device}")
    if tuple(t.shape) != (n_blocks,):
        raise ValueError(f"{name} must be ({n_blocks},); got {tuple(t.shape)}")


def _check_operands(scalars, fn_ids, packed, lo, hi, block_forms, dim,
                    n_rounds, round_base, block_tcols, sampler="mc",
                    block_sweep=None, block_adapt=None):
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
    if dim < 1:
        raise ValueError(f"dim must be >= 1; got {dim}")
    if sampler not in ("mc", "sobol"):
        raise ValueError(f"sampler must be 'mc' or 'sobol'; got {sampler!r}")
    if sampler == "sobol" and dim > sobol.MAX_DIM:
        raise ValueError(f"sampler='sobol' draws at most {sobol.MAX_DIM} "
                         f"dims; got dim={dim}")
    if n_rounds < 1:
        raise ValueError(f"n_rounds must be >= 1; got {n_rounds}")
    if scalars.device.type != "cpu" or tuple(scalars.shape) not in ((4,), (5,)):
        raise ValueError(f"scalars must be u32[4], or u32[5] with "
                         f"round_stride, on the CPU; got "
                         f"{tuple(scalars.shape)} on {scalars.device}")
    if n_rounds > 1 and scalars.shape[0] < 5:
        raise ValueError("multi-round launches need scalars[4] = round_stride "
                         "(pack_scalars(..., round_stride=...))")
    n_blocks = n_pad // F_BLK
    _host_meta("block_forms", block_forms, n_blocks)
    if round_base is not None:
        _host_meta("round_base", round_base, n_blocks)
    if block_tcols is not None:
        _host_meta("block_tcols", block_tcols, n_blocks)
        tc = block_tcols.tolist()
        if any(t != -1 and not 0 <= t <= packed.shape[1] - 2 * dim for t in tc):
            raise ValueError(f"block_tcols must be -1 or leave 2 * dim = "
                             f"{2 * dim} transform columns inside the "
                             f"{packed.shape[1]} packed columns; got {tc}")
    if block_sweep is not None:
        if (block_sweep.device.type != "cpu" or block_sweep.ndim != 2
                or block_sweep.shape[0] % 2
                or block_sweep.shape[1] != n_blocks):
            raise ValueError(f"block_sweep must be i32[2 * S, {n_blocks}] on "
                             f"the CPU; got {tuple(block_sweep.shape)} on "
                             f"{block_sweep.device}")
        pairs = block_sweep.to(torch.int64).view(-1, 2, n_blocks)
        dst, src = pairs[:, 0], pairs[:, 1]
        used = dst >= 0
        # a block's pairs read its table columns in order: src_j = src_0 + j
        j = torch.arange(pairs.shape[0])[:, None]
        if bool((used & ((src != src[:1] + j) | (src >= packed.shape[1])
                         | (dst >= src[:1]))).any()):
            raise ValueError("block_sweep must pair base columns with the "
                             "block's table columns in order, after the "
                             "base columns and inside the packed columns")
    if block_adapt is not None:
        if (block_adapt.device.type != "cpu"
                or tuple(block_adapt.shape) != (2, n_blocks)):
            raise ValueError(f"block_adapt must be i32[2, {n_blocks}] on the "
                             f"CPU; got {tuple(block_adapt.shape)} on "
                             f"{block_adapt.device}")
        if any(a != -1 and (a < 0 or nb < 1 or a + dim * (nb + 1) > packed.shape[1])
               for a, nb in zip(*block_adapt.tolist())):
            raise ValueError(f"block_adapt must be -1 or leave dim * (n_bins "
                             f"+ 1) grid-edge columns, n_bins >= 1, inside "
                             f"the {packed.shape[1]} packed columns; got "
                             f"{block_adapt.tolist()}")


def _round_words(scalars, n_rounds: int, round_base, n_blocks: int):
    """(k0, k1, sample_offset, n_valid, round_stride, u32 round_base per
    block) as python ints and an int64 tensor."""
    words = [int(v) for v in scalars.tolist()]
    k0, k1, offset, n_valid = words[:4]
    stride = words[4] if len(words) > 4 else 0
    base = (torch.zeros(n_blocks, dtype=torch.int64) if round_base is None
            else rng.as_u32(round_base))
    return k0, k1, offset, n_valid, stride, base


def fused_mc(scalars, fn_ids, packed, lo, hi, block_forms, *, dim: int,
             n_sample_blocks: int, n_rounds: int = 1, round_base=None,
             block_tcols=None, block_sweep=None, block_adapt=None,
             sampler: str = "mc", block_meta=None,
             dirvecs=None) -> torch.Tensor:
    """One fused launch: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; raises on any other device.  ``block_meta``
    and ``dirvecs`` only spare the CUDA kernel a copy (see
    :func:`fused_mc_cuda`)."""
    record_launch()
    kind = packed.device.type
    kw = dict(dim=dim, n_sample_blocks=n_sample_blocks, n_rounds=n_rounds,
              round_base=round_base, block_tcols=block_tcols,
              block_sweep=block_sweep, block_adapt=block_adapt,
              sampler=sampler)
    if kind == "cuda":
        return fused_mc_cuda(scalars, fn_ids, packed, lo, hi, block_forms,
                             block_meta=block_meta, dirvecs=dirvecs, **kw)
    if kind == "cpu":
        return fused_mc_plain(scalars, fn_ids, packed, lo, hi, block_forms, **kw)
    raise ValueError(f"fused_mc runs on 'cuda' or 'cpu' tensors; got {kind!r}")


def fused_mc_plain(scalars, fn_ids, packed, lo, hi, block_forms, *, dim: int,
                   n_sample_blocks: int, n_rounds: int = 1, round_base=None,
                   block_tcols=None, block_sweep=None, block_adapt=None,
                   sampler: str = "mc") -> torch.Tensor:
    """Plain PyTorch version of the fused kernel, on the tensors' device.

    Loops over rounds; each round draws whole ``CHUNK_SAMPLES``-sample
    chunks (several per step, bounded by ``_PLAIN_STEP_ELEMS``) at its
    rows' window starts (Threefry uniforms, or the Sobol points of each
    block's window from :mod:`repro_torch.core.sobol` XOR each row's
    shift), evaluates each (form, compactified, sweep map) group's body
    on its rows, sums each chunk and folds the chunk sums in order, as
    the kernel's pass 2 does.  (Folding 2048-sample block sums one by
    one instead loses up to 15 times more to f32 rounding at 10^6
    samples when the block sums are nearly equal, as Sobol's are.)
    Every round runs the same code on the same shapes, so round ``r``
    equals a single-round call at that round's offset bit for bit.
    """
    from repro_torch.kernels import registry
    _check_operands(scalars, fn_ids, packed, lo, hi, block_forms, dim,
                    n_rounds, round_base, block_tcols, sampler, block_sweep,
                    block_adapt)
    n_pad = fn_ids.shape[0]
    n_blocks = n_pad // F_BLK
    k0, k1, offset, n_valid, stride, base = _round_words(
        scalars, n_rounds, round_base, n_blocks)
    device = packed.device
    fid = rng.as_u32(fn_ids)
    if sampler == "sobol":
        shift = sobol.shifts_for(k0, k1, fid, dim)
    else:
        c1 = rng.counter_c1(fid[:, None],
                            torch.arange(dim, dtype=torch.int64, device=device))
    width = hi - lo
    blk_tcols = (np.full(n_blocks, -1, np.int64) if block_tcols is None
                 else block_tcols.numpy().astype(np.int64))
    blk_sweep = (np.zeros((0, n_blocks), np.int64) if block_sweep is None
                 else block_sweep.numpy().astype(np.int64))
    blk_adapt = (np.tile(np.asarray([[-1], [0]], np.int64), (1, n_blocks))
                 if block_adapt is None else block_adapt.numpy().astype(np.int64))
    keys = [(int(f), int(t), tuple((int(blk_sweep[2 * j, b]),
                                    int(blk_sweep[2 * j + 1, b]))
                                   for j in range(blk_sweep.shape[0] // 2)
                                   if blk_sweep[2 * j, b] >= 0),
             (int(blk_adapt[0, b]), int(blk_adapt[1, b])))
            for b, (f, t) in enumerate(zip(block_forms.tolist(), blk_tcols))]
    groups = []
    for key in sorted(set(keys)):
        f, t, pairs, (acol, n_bins) = key
        body = registry.by_id(f).body
        if pairs:
            body = swept_body(body, pairs[0][1], tuple(d for d, _ in pairs))
        if t >= 0:
            body = compactified_body(body, t)
        if acol >= 0:
            body = adapted_body(body, acol, n_bins)
        rows = np.concatenate([np.arange(b * F_BLK, (b + 1) * F_BLK)
                               for b, k in enumerate(keys) if k == key])
        groups.append((body, torch.from_numpy(rows).to(device)))
    chunk_blocks = CHUNK_SAMPLES // S_BLK
    step = chunk_blocks * max(1, _PLAIN_STEP_ELEMS // (n_pad * CHUNK_SAMPLES * dim))
    zero = torch.zeros((), dtype=torch.float32, device=device)
    out = []
    for r in range(n_rounds):
        window = (offset + base.to(device) + r * stride) & rng.MASK32
        acc = torch.zeros(n_pad, 2, dtype=torch.float32, device=device)
        for j0 in range(0, n_sample_blocks, step):
            k = min(step, n_sample_blocks - j0)
            local = j0 * S_BLK + torch.arange(k * S_BLK, dtype=torch.int64,
                                              device=device)
            c0 = (window[:, None] + local[None, :]) & rng.MASK32
            if sampler == "sobol":
                # one point per (block, sample), shared by its 16 rows
                pts = torch.repeat_interleave(sobol.sobol_bits(c0, dim),
                                              F_BLK, dim=0)
                bits = pts ^ shift[:, None, :]
            else:
                c0 = torch.repeat_interleave(c0, F_BLK, dim=0)
                bits = rng.random_bits(k0, k1, c0[:, :, None], c1[:, None, :])
            u = rng.bits_to_uniform(bits)
            x = lo[:, None, :] + u * width[:, None, :]
            vals = torch.empty(n_pad, k * S_BLK, dtype=torch.float32,
                               device=device)
            for body, rows in groups:
                xr = x[rows]
                vals[rows] = body(lambda d, xr=xr: xr[:, :, d], packed[rows],
                                  dim)
            vals = torch.where(local[None, :] < n_valid, vals, zero)
            for v in vals.split(CHUNK_SAMPLES, dim=1):
                acc = acc + torch.stack([v.sum(-1), (v * v).sum(-1)], dim=-1)
        out.append(acc)
    return torch.stack(out)


def sobol_dirvecs(dim: int) -> torch.Tensor:
    """The Sobol direction vectors ``core.sobol.direction_vectors(dim)`` as
    an int32 (dim, 32) CPU tensor of their bit patterns (the kernel's
    ``sobol_dirs`` operand)."""
    return torch.from_numpy(sobol.direction_vectors(dim).view(np.int32).copy())


def block_meta_host(block_forms, block_tcols=None, block_sweep=None,
                    block_adapt=None) -> torch.Tensor:
    """The kernel's per-block metadata as one CPU int32[4 + 2 * S,
    n_blocks] tensor: form ids, first transform columns (-1: none), the
    ``block_sweep`` rows, then first grid-edge columns (-1: none) and bins
    per axis (``block_adapt``)."""
    n_blocks = block_forms.shape[0]
    tcols = (torch.full((n_blocks,), -1, dtype=torch.int32)
             if block_tcols is None else block_tcols.to(torch.int32))
    adapt = (block_adapt_tensor([(-1, 0)] * n_blocks)
             if block_adapt is None else block_adapt.to(torch.int32))
    rows = [block_forms.to(torch.int32)[None], tcols[None]]
    if block_sweep is not None:
        rows.append(block_sweep.to(torch.int32))
    rows.append(adapt)
    return torch.cat(rows).contiguous()


def fused_mc_cuda(scalars, fn_ids, packed, lo, hi, block_forms, *, dim: int,
                  n_sample_blocks: int, n_rounds: int = 1, round_base=None,
                  block_tcols=None, block_sweep=None, block_adapt=None,
                  sampler: str = "mc", block_meta=None,
                  dirvecs=None) -> torch.Tensor:
    """Launch the CUDA kernel (``csrc/fused_mc.cu``) on the current stream.

    Checks device, dtype, shape and contiguity, allocates the output and
    the pass-1 scratch, and raises if the launch reports a CUDA error.
    ``block_meta`` is :func:`block_meta_host` already on the card
    (``multi.plan_spec`` puts it there once per plan); without it it is
    copied with :func:`to_card` on every launch.  ``round_base``, when
    given, is copied the same way; without it the kernel starts every
    block's window at ``sample_offset``.  With ``sampler="sobol"``,
    ``dirvecs`` is :func:`sobol_dirvecs` on the card (``plan_spec`` keeps
    it in the plan); without it the table is copied per launch.  Nothing
    here waits for the card.
    """
    from repro_torch.kernels import build
    _check_operands(scalars, fn_ids, packed, lo, hi, block_forms, dim,
                    n_rounds, round_base, block_tcols, sampler, block_sweep,
                    block_adapt)
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
    n_pad, n_cols = packed.shape
    n_blocks = n_pad // F_BLK
    k0, k1, offset, n_valid, stride, base = _round_words(
        scalars, n_rounds, round_base, n_blocks)
    n_eff = min(n_valid, n_sample_blocks * S_BLK)
    n_chunks = max(1, math.ceil(n_eff / CHUNK_SAMPLES))
    fid = rng.u32_bits(rng.as_u32(fn_ids)).contiguous()
    has_compact = block_tcols is not None and bool((block_tcols >= 0).any())
    has_adapt = block_adapt is not None and max(block_adapt[0].tolist(), default=-1) >= 0
    n_sweep = 0 if block_sweep is None else block_sweep.shape[0] // 2
    has_sweep = n_sweep > 0 and bool((block_sweep >= 0).any())
    if block_meta is None:
        block_meta = to_card(block_meta_host(block_forms, block_tcols,
                                             block_sweep, block_adapt), device)
    elif (block_meta.device != device or block_meta.dtype != torch.int32
          or tuple(block_meta.shape) != (4 + 2 * n_sweep, n_blocks)
          or not block_meta.is_contiguous()):
        raise ValueError(f"block_meta must be contiguous int32 "
                         f"({4 + 2 * n_sweep}, {n_blocks}) on {device}; got "
                         f"{block_meta.dtype} {tuple(block_meta.shape)} on "
                         f"{block_meta.device}")
    if sampler != "sobol":
        dirvecs = None
    elif dirvecs is None:
        dirvecs = to_card(sobol_dirvecs(dim), device)
    elif (dirvecs.device != device or dirvecs.dtype != torch.int32
          or tuple(dirvecs.shape) != (dim, 32) or not dirvecs.is_contiguous()):
        raise ValueError(f"dirvecs must be contiguous int32 ({dim}, 32) on "
                         f"{device}; got {dirvecs.dtype} "
                         f"{tuple(dirvecs.shape)} on {dirvecs.device}")
    base_dev = (None if round_base is None
                else to_card(rng.u32_bits(base), device))
    scratch = torch.empty(n_rounds, n_pad, n_chunks, 2, dtype=torch.float32,
                          device=device)
    out = torch.empty(n_rounds, n_pad, 2, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.zmc_fused_mc(k0, k1, offset, n_eff, stride, n_rounds,
                               None if base_dev is None else base_dev.data_ptr(),
                               fid.data_ptr(), block_meta.data_ptr(),
                               n_sweep, int(has_compact) | 2 * int(has_adapt),
                               None if dirvecs is None else dirvecs.data_ptr(),
                               packed.data_ptr(), n_cols,
                               lo.data_ptr(), hi.data_ptr(), dim, n_pad, n_chunks,
                               scratch.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"zmc_fused_mc launch failed with CUDA error {err}")
    with _COUNT_LOCK:
        _VARIANT_LAUNCHES["fused_mc_rounds" if n_rounds > 1 else "fused_mc"] += 1
        for name, flag in (("fused_mc_compactified", has_compact),
                           ("fused_mc_sobol", sampler == "sobol"),
                           ("fused_mc_swept", has_sweep),
                           ("fused_mc_adapted", has_adapt)):
            _VARIANT_LAUNCHES[name] += flag
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


def sobol_cuda(k0: int, k1: int, idx: torch.Tensor, fn_ids: torch.Tensor,
               dim: int):
    """Sobol points and shifts as the device header computes them
    (test-only kernel; nothing on the main path calls it): for u32
    indices ``idx`` and function ids ``fn_ids`` (one per index) on one
    CUDA device, returns int64 u32 ``(points, shifts)`` of shape
    ``(n, dim)``, to hold against ``core.sobol.sobol_bits`` and
    ``shifts_for``."""
    from repro_torch.kernels import build
    if idx.device.type != "cuda" or fn_ids.device != idx.device:
        raise ValueError("sobol_cuda needs idx and fn_ids on one CUDA device")
    if idx.shape != fn_ids.shape or idx.ndim != 1:
        raise ValueError(f"idx {tuple(idx.shape)} and fn_ids "
                         f"{tuple(fn_ids.shape)} must be one 1-d shape")
    lib = build.load("zmc_fused_mc")
    a = rng.u32_bits(rng.as_u32(idx)).contiguous()
    b = rng.u32_bits(rng.as_u32(fn_ids)).contiguous()
    v = to_card(sobol_dirvecs(dim), idx.device)
    pts = torch.empty(a.numel(), dim, dtype=torch.int32, device=idx.device)
    shs = torch.empty_like(pts)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = lib.zmc_sobol(v.data_ptr(), dim, int(k0) & rng.MASK32,
                            int(k1) & rng.MASK32, a.data_ptr(), b.data_ptr(),
                            pts.data_ptr(), shs.data_ptr(), a.numel(), stream)
    if err != 0:
        raise RuntimeError(f"zmc_sobol launch failed with CUDA error {err}")
    return rng.as_u32(pts), rng.as_u32(shs)


def sobol_walk_cuda(start: int, n: int, dim: int, device) -> torch.Tensor:
    """Sobol points of the indices ``start + i`` (u32 wrap), ``i < n``, as
    pass 1 computes them (test-only kernel; nothing on the main path calls
    it): one CUDA block of 256 threads, thread ``t`` building the point of
    ``start + t`` and walking its stride-256 run in Gray-code order.
    Returns int64 u32 points of shape ``(n, dim)`` on ``device``, to hold
    against ``core.sobol.sobol_bits``."""
    from repro_torch.kernels import build
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"sobol_walk_cuda needs a CUDA device; got {device}")
    lib = build.load("zmc_fused_mc")
    v = to_card(sobol_dirvecs(dim), device)
    pts = torch.empty(n, dim, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.zmc_sobol_walk(v.data_ptr(), dim, int(start) & rng.MASK32, n,
                                 pts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"zmc_sobol_walk launch failed with CUDA error {err}")
    return rng.as_u32(pts)


def make_family_impl(form, sampler: str = "mc"):
    """Single-family impl of one form and sampler: pads the family to
    ``F_BLK`` rows and makes one :func:`fused_mc` launch."""
    from repro_torch.core.direct_mc import SumsState, n_tensor

    def impl(family, n_samples: int, key, *, fn_offset: int = 0,
             sample_offset=0, fn_ids=None) -> SumsState:
        n_fn, dim = family.n_fn, family.dim
        if not form.supports(dim=dim, sampler=sampler,
                             compactified=family.compact, sweep=family.swept,
                             adapted=bool(family.adapt_bins)):
            raise ValueError(
                f"kernel {form.name!r} does not support dim={dim} with "
                f"sampler={sampler!r}"
                + (" on a compactified family" if family.compact else "")
                + (f" swept over {family.swept}" if family.swept else "")
                + (" on an adapted family" if family.adapt_bins else ""))
        device = family.device
        if fn_ids is None:
            fn_ids = fn_offset + torch.arange(n_fn, dtype=torch.int64,
                                              device=device)
        pad = math.ceil(n_fn / F_BLK) * F_BLK - n_fn
        n_blocks = (n_fn + pad) // F_BLK
        _, packed = body_and_packed(form, family)
        out = fused_mc(
            pack_scalars(key, sample_offset, n_samples),
            pad_rows(rng.as_u32(fn_ids, device), pad),
            pad_rows(packed, pad).contiguous(),
            pad_rows(family.domains[..., 0], pad).contiguous(),
            pad_rows(family.domains[..., 1], pad).contiguous(),
            torch.full((n_blocks,), form.form_id, dtype=torch.int32),
            dim=dim, n_sample_blocks=max(1, math.ceil(int(n_samples) / S_BLK)),
            block_tcols=torch.full((n_blocks,), transform_col(form, family),
                                   dtype=torch.int32),
            block_sweep=(block_sweep_tensor([sweep_pairs(form, family)] * n_blocks)
                         if family.swept else None),
            block_adapt=block_adapt_tensor([adapt_col(form, family)] * n_blocks),
            sampler=sampler)[0]
        return SumsState(s1=out[:n_fn, 0], s2=out[:n_fn, 1],
                         n=n_tensor(n_samples, device))

    impl.__name__ = form.name if sampler == "mc" else f"{form.name}@{sampler}"
    impl.form = form
    impl.sampler = sampler
    return impl
