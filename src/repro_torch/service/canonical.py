"""Deterministic canonicalization + content hashing of integration
requests (port of ``repro.service.canonical``).

Two clients that ask for the same integral must map to the same cache
entry, even when they built their :class:`IntegrandFamily` objects
independently (fresh closures, different cosmetic names, float64 instead
of float32 parameters).  What "the same integral" means to the service:

* the **numerical content** (parameter tree and domain boxes) is
  serialized leaf by leaf (dict keys sorted, dtypes normalized to what
  the engine computes in: f32 for floats, int64 for integers) and hashed;
* the **code identity** of the integrand is the registered kernel-form
  name when the family declares one (stable across processes, machines
  and packages), otherwise a structural fingerprint of the Python
  function: bytecode, consts, names, and the *values* captured in
  closure cells and defaults;
* the cosmetic ``name`` is excluded on purpose.

Infinite domains are compactified *before* hashing, mirroring what the
engine does before sampling.

A **sweep request** (one template family x a parameter grid)
canonicalizes here too: axes sorted by name, values to f32, points in
row-major (last-axis-fastest) order, chunked into fixed
:data:`DEFAULT_SWEEP_SLICE`-point *slices*, each an ordinary swept
family that hashes by content like any other.  Two clients sweeping
overlapping grids share cache streams wherever their canonical slices
align.

For a family with a registered form, :func:`family_hash` hashes the same
bytes as ``repro.service.family_hash`` (the tree structure string of
``jax.tree_util`` and its leaf order, the same dtype normalization), so
the two packages agree on stream ids and a state dir written by one
serves the other; a sweep's slices get the same names and hashes in
both packages.

The hash addresses the service's result cache; it is not a security
boundary.
"""

from __future__ import annotations

import hashlib
import math
import types
from typing import Any

import numpy as np
import torch

from repro_torch.core.integrand import IntegrandFamily, MultiFunctionSpec
from repro_torch.core.tree import tree_leaves, treedef_str


def _hash_array(h, leaf) -> None:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    arr = np.asarray(leaf)
    # the engine computes in f32; f64 inputs are not a distinct integral
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    elif arr.dtype.kind in "iu":
        arr = arr.astype(np.int64)
    arr = np.ascontiguousarray(arr)
    h.update(str(arr.dtype).encode())
    h.update(repr(arr.shape).encode())
    h.update(arr.tobytes())


def _hash_code(h, code: types.CodeType) -> None:
    h.update(code.co_code)
    h.update(repr(code.co_names).encode())
    h.update(repr(code.co_varnames).encode())
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _hash_code(h, const)
        else:
            h.update(repr(const).encode())


def _hash_value(h, value: Any) -> None:
    """Hash one captured value (closure cell / default / const)."""
    if isinstance(value, (np.ndarray, torch.Tensor)) or np.isscalar(value):
        _hash_array(h, value)
    elif callable(value) and hasattr(value, "__code__"):
        _hash_callable(h, value)
    elif isinstance(value, (tuple, list)):
        h.update(b"seq")
        for v in value:
            _hash_value(h, v)
    elif isinstance(value, dict):
        h.update(b"map")
        for k in sorted(value, key=repr):
            h.update(repr(k).encode())
            _hash_value(h, value[k])
    else:
        h.update(repr(value).encode())


def _hash_global(h, value: Any) -> None:
    """Hash one module-global an integrand references.

    Data values (arrays, scalars, containers) hash by content — a
    module-level ``SCALE = 2.0`` versus ``3.0`` must produce different
    integrals.  Modules and functions hash by import path (stable across
    processes, and avoids recursing into torch internals); a referenced
    *helper function's* body changing is therefore not detected — keep
    integrand math in the closure, not in mutable helpers.
    """
    if isinstance(value, types.ModuleType):
        h.update(f"module:{value.__name__}".encode())
    elif callable(value) and hasattr(value, "__code__"):
        h.update(f"fn:{getattr(value, '__module__', '')}."
                 f"{getattr(value, '__qualname__', '')}".encode())
    else:
        _hash_value(h, value)


def _hash_callable(h, fn) -> None:
    _hash_code(h, fn.__code__)
    for cell in fn.__closure__ or ():
        try:
            _hash_value(h, cell.cell_contents)
        except ValueError:  # empty cell (still being defined)
            h.update(b"empty-cell")
    for default in fn.__defaults__ or ():
        _hash_value(h, default)
    for name, default in sorted((fn.__kwdefaults__ or {}).items()):
        h.update(name.encode())
        _hash_value(h, default)
    # globals the code references (co_names covers loads of globals and
    # builtins; unresolvable names are attribute accesses / builtins)
    for name in fn.__code__.co_names:
        if name in fn.__globals__:
            h.update(name.encode())
            _hash_global(h, fn.__globals__[name])


def _hash_pytree(h, tree) -> None:
    # the structure string and leaf order of jax.tree_util.tree_flatten,
    # so the bytes hashed are the reference's
    h.update(treedef_str(tree).encode())
    for leaf in tree_leaves(tree):
        _hash_array(h, leaf)


def canonical_family(family: IntegrandFamily) -> IntegrandFamily:
    """The form of ``family`` the service evaluates and hashes.

    Identical to what ``ZMCMultiFunctions`` runs: infinite boxes rewritten
    to finite ones.  Idempotent, so pre-canonicalized submissions are
    no-ops.
    """
    return family.compactified()


def family_hash(family: IntegrandFamily, *, canonicalize: bool = True) -> str:
    """Content hash of one integrand family (hex sha256).

    Families that evaluate identical integrals — same code shape, same
    parameters, same domains — hash identically regardless of who built
    them; the label ``name`` does not participate.
    """
    if canonicalize:
        family = canonical_family(family)
    h = hashlib.sha256()
    if family.kernel is not None:
        from repro_torch.kernels import registry
        if registry.form(family.kernel) is not None:
            # registered form: code identity is the (stable) registry name
            h.update(b"form:")
            h.update(family.kernel.encode())
        else:
            h.update(b"code:")
            _hash_callable(h, family.fn)
    else:
        h.update(b"code:")
        _hash_callable(h, family.fn)
    _hash_pytree(h, family.params)
    _hash_array(h, family.domains)
    return h.hexdigest()


# Points per canonical sweep slice.  Part of the dedupe contract: two
# sweeps share cache streams only where their canonical slices align, so
# every engine chunks at the same quantum (``sweep_slice_points`` on the
# engine, for tests; another value orphans, but never corrupts, cached
# sweep streams).  The same value as ``repro``'s.
DEFAULT_SWEEP_SLICE = 64


def canonical_grid(grid: dict) -> tuple:
    """Normalize a sweep grid to ``((name, f32 values), ...)``: axes sorted
    by parameter name, values f32 with a leading point axis (scalars
    become length-1 axes; vector-valued parameters keep their trailing
    shape)."""
    if not grid:
        raise ValueError("sweep grid must name at least one axis")
    axes = []
    for name in sorted(grid):
        vals = grid[name]
        if isinstance(vals, torch.Tensor):
            vals = vals.detach().cpu().numpy()
        vals = np.asarray(vals, np.float32)
        if vals.ndim == 0:
            vals = vals.reshape(1)
        if vals.shape[0] == 0:
            raise ValueError(f"sweep axis {name!r} is empty")
        axes.append((str(name), vals))
    return tuple(axes)


def grid_table(axes: tuple) -> tuple[dict, tuple[int, ...]]:
    """Row-major point table of a canonical grid: ``(table, shape)``,
    ``table[name]`` the axis value at every point (last axis fastest),
    ``shape`` the per-axis counts in sorted-name order."""
    sizes = [int(v.shape[0]) for _, v in axes]
    idx = np.indices(sizes).reshape(len(sizes), -1)
    table = {name: v[idx[i]] for i, (name, v) in enumerate(axes)}
    return table, tuple(sizes)


def sweep_slices(template: IntegrandFamily, grid: dict, *,
                 slice_points: int = DEFAULT_SWEEP_SLICE) -> tuple:
    """Canonical slice families of one sweep request.

    Chunks the row-major point enumeration into ``slice_points``-sized
    pieces, each a canonical (compactified) swept family named
    ``"<template>:sweep[start:stop]"``: the unit the cache keys on.  The
    same template and grid give the same slices, and a prefix grid
    (extending only the slowest axis) reproduces its aligned slices, so
    overlapping sweeps dedupe below the request level.

    Returns ``(slice_families, grid_shape, axis_names)``.
    """
    if int(slice_points) < 1:
        raise ValueError(f"slice_points must be >= 1, got {slice_points}")
    axes = canonical_grid(grid)
    table, shape = grid_table(axes)
    n_points = math.prod(shape)
    fams = []
    for start in range(0, n_points, int(slice_points)):
        stop = min(start + int(slice_points), n_points)
        chunk = {name: vals[start:stop] for name, vals in table.items()}
        fam = canonical_family(template.swept_over(chunk))
        fam.name = f"{template.name}:sweep[{start}:{stop}]"
        fams.append(fam)
    return tuple(fams), shape, tuple(name for name, _ in axes)


def spec_hash(spec, *, sampler: str = "mc") -> str:
    """Order-sensitive hash of a whole request spec (family list and
    sampler), as ``repro``'s."""
    families = spec.families if isinstance(spec, MultiFunctionSpec) else tuple(spec)
    h = hashlib.sha256()
    h.update(sampler.encode())
    for fam in families:
        h.update(family_hash(fam).encode())
    return h.hexdigest()
