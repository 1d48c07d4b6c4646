"""Integrand specification: function *families* (PyTorch).

Port of ``repro.core.integrand``.  An
:class:`IntegrandFamily` is one batched PyTorch function plus a dict of
stacked parameters (leading axis = function index) and a per-function
domain box; a :class:`MultiFunctionSpec` is an ordered list of families,
the unit the multi-function solver consumes.

Where ``repro`` writes ``fn(x, params)`` for ONE function and vmaps it,
the port writes it batched over the function axis: ``fn(x, p)`` takes
``x`` of shape ``(n_fn, B, dim)`` and the whole parameter dict, and
returns ``(n_fn, B)``.

:func:`family_from_numpy` builds a family from parameters and domains
taken out of a ``repro`` family as numpy arrays, so the same integrands
can go through both packages.

Infinite boxes are rewritten to finite ones by :meth:`IntegrandFamily
.compactified` (``repro_torch.core.domains.compactify``); the result
keeps its kernel form, and the fused kernel applies the transform in its
compactified blocks.

A single-function template scanned over a table of parameter points is
one swept family (:meth:`IntegrandFamily.swept_over`): one function row
per point, its params the ``{"base": template, "table": per-point
values}`` wrapper; the fused kernel substitutes the table columns into
the template's packed row.  Sweep before compactifying, as ``repro``
composes the stages.

A finite-box family sampled through a VEGAS importance grid is an
adapted family (:meth:`IntegrandFamily.adapted`): its params are the
``{"inner": params, "grid": (n_fn, dim, n_bins + 1) edges}`` wrapper,
its box the unit cube; the fused kernel maps each draw through the grid
in its adapted blocks.  Adapt last: ``adapted(compactified(swept))``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import domains as domains_lib
from repro_torch.core.tree import tree_leaves, tree_map


@dataclasses.dataclass
class IntegrandFamily:
    """A batch of integrands sharing one functional form.

    Attributes:
      fn: ``fn(x, params) -> values``; ``x`` is (n_fn, B, dim), ``params``
        the dict below, the result (n_fn, B).
      params: dict of tensors (or nested dicts of them), each with
        leading axis ``n_fn``.
      domains: (n_fn, dim, 2) float32 tensor of [lo, hi] boxes.  May
        contain +-inf; the solvers compactify before sampling.
      name: label used in reports and checkpoint tags.
      kernel: registered kernel form name (``repro_torch.kernels.registry``)
        or ``None`` for the chunked PyTorch path only.
      compact: set by :meth:`compactified`: ``params`` is the
        ``{"inner": user params, "aux": {"kind", "shift"}}`` wrapper
        around an infinite-domain integrand, and kernel dispatch applies
        the transform stage.
      swept: set by :meth:`swept_over`: the sorted parameter names a
        sweep table overrides.  ``params`` (``params["inner"]`` once
        compactified) is the ``{"base": template params, "table": {name:
        per-point values}}`` wrapper, one function row per grid point.
      adapt_bins: set by :meth:`adapted`: bins per axis of the VEGAS
        importance grid (0: unadapted).  ``params`` is the ``{"inner":
        wrapped params, "grid": edges}`` wrapper and the box the unit
        cube.
    """

    fn: Callable[[torch.Tensor, dict], torch.Tensor]
    params: dict
    domains: torch.Tensor
    name: str = "family"
    kernel: str | None = None
    compact: bool = False
    swept: tuple[str, ...] = ()
    adapt_bins: int = 0

    @property
    def n_fn(self) -> int:
        return int(self.domains.shape[0])

    @property
    def dim(self) -> int:
        return int(self.domains.shape[1])

    @property
    def device(self) -> torch.device:
        return self.domains.device

    def validate(self) -> "IntegrandFamily":
        d = self.domains
        if d.ndim != 3 or d.shape[-1] != 2:
            raise ValueError(f"domains must be (n_fn, dim, 2); got {tuple(d.shape)}")
        for leaf in tree_leaves(self.params):
            if tuple(leaf.shape[:1]) != (d.shape[0],):
                raise ValueError(
                    f"every params leaf needs leading axis n_fn={d.shape[0]}; "
                    f"got a leaf of shape {tuple(leaf.shape)}")
        finite = torch.isfinite(d).all(-1)
        lo_le_hi = torch.where(finite, d[..., 0] <= d[..., 1],
                               torch.ones_like(finite))
        if not bool(lo_le_hi.all()):
            raise ValueError("domain boxes must satisfy lo <= hi")
        return self

    def to(self, device) -> "IntegrandFamily":
        """The same family with its tensors on ``device``."""
        return dataclasses.replace(
            self, params=tree_map(lambda v: v.to(device), self.params),
            domains=self.domains.to(device))

    def compactified(self) -> "IntegrandFamily":
        """An equivalent family whose domain box is finite.

        Keeps :attr:`kernel`: registered forms evaluate compactified
        families in the fused kernel (the transform's kind and shift pack
        into parameter columns after the form's own).  Finite families
        are returned as they are.
        """
        if domains_lib.is_finite_box(self.domains):
            return self
        fn2, new_domains, aux = domains_lib.compactify(self.fn, self.domains)
        return IntegrandFamily(
            fn=fn2, params={"inner": self.params, "aux": aux},
            domains=new_domains, name=self.name + ":compactified",
            kernel=self.kernel, compact=True, swept=self.swept)

    def inner(self) -> "IntegrandFamily":
        """The pre-transform parameter view of a compactified family:
        same shapes and finite box, the user's ``params``.  Kernel
        packers consume this.  Unwraps the grid stage first on an adapted
        family; identity for other families."""
        if self.adapt_bins:
            return self.adapt_inner().inner()
        if not self.compact:
            return self
        return IntegrandFamily(fn=self.fn, params=self.params["inner"],
                               domains=self.domains, name=self.name,
                               kernel=self.kernel, swept=self.swept)

    def adapted(self, edges, *, epoch: int = 1) -> "IntegrandFamily":
        """This finite-box family sampled through a VEGAS importance grid.

        Args:
          edges: (n_fn, dim, n_bins + 1) per-axis bin edges, strictly
            increasing and spanning this family's box (a numpy array or
            tensor; :func:`repro_torch.core.adaptive.refine_edges` output,
            or a grid record ``repro`` journaled).
          epoch: grid-epoch label; it suffixes :attr:`name` only.

        Returns a family whose box is the unit cube: uniforms map through
        the grid's inverse CDF with the bin-width Jacobian folded into the
        value (``repro_torch.core.adaptive.apply_map``), an unbiased
        importance-sampled estimate of the same integral.  Keeps
        :attr:`kernel`.  Grids never nest: refit from
        :meth:`adapt_inner`.
        """
        if self.adapt_bins:
            raise ValueError("family is already adapted — refit from "
                             "adapt_inner(), grids never nest")
        if not domains_lib.is_finite_box(self.domains):
            raise ValueError("importance grids need a finite box — "
                             "compactify before adapting")
        if isinstance(edges, torch.Tensor):
            edges = edges.detach().cpu().numpy()
        edges = _t(edges, self.device)
        if edges.ndim != 3 or tuple(edges.shape[:2]) != (self.n_fn, self.dim):
            raise ValueError(
                f"edges must be (n_fn={self.n_fn}, dim={self.dim}, "
                f"n_bins + 1); got {tuple(edges.shape)}")
        n_bins = int(edges.shape[-1]) - 1
        if n_bins < 1:
            raise ValueError("importance grids need at least one bin")
        unit = torch.zeros(self.n_fn, self.dim, 2, dtype=torch.float32,
                           device=self.device)
        unit[..., 1] = 1.0
        return IntegrandFamily(
            fn=adapted_fn(self.fn), params={"inner": self.params, "grid": edges},
            domains=unit, name=f"{self.name}:adapted[e{int(epoch)}]",
            kernel=self.kernel, compact=self.compact, swept=self.swept,
            adapt_bins=n_bins)

    def adapt_inner(self) -> "IntegrandFamily":
        """The pre-grid view of an adapted family: ``params`` without the
        ``{"inner", "grid"}`` wrapper and the original box recovered from
        the grid's outer edges.  Kernel packers consume this; ``fn`` is
        kept as it is.  Identity for unadapted families."""
        if not self.adapt_bins:
            return self
        edges = self.params["grid"]
        box = torch.stack([edges[..., 0], edges[..., -1]], dim=-1)
        return IntegrandFamily(fn=self.fn, params=self.params["inner"],
                               domains=box, name=self.name,
                               kernel=self.kernel, compact=self.compact,
                               swept=self.swept)

    def swept_over(self, table: dict) -> "IntegrandFamily":
        """Sweep this single-function template over a parameter table.

        Args:
          table: parameter name (a top-level key of :attr:`params`) ->
            per-point values of shape ``(n_points,) + leaf.shape[1:]``.
        Returns:
          A family with ``n_fn == n_points``: row ``j`` is the template
          with the named parameters overridden by ``table[name][j]``.
          The chunked path merges the table into the base params; the
          fused kernel substitutes the table columns into the packed
          template row, so each point's sums equal those of the point
          as its own family at the same function id.

        Sweep before :meth:`compactified`, as ``repro``'s canonicalizer
        composes ``compactify(sweep(template))``.
        """
        if self.compact or self.adapt_bins:
            raise ValueError("sweep the template before compactifying or "
                             "adapting (canonicalization composes the "
                             "stages)")
        if self.n_fn != 1:
            raise ValueError(
                f"sweep template must be a single function (n_fn == 1); "
                f"got n_fn={self.n_fn}")
        if not isinstance(self.params, dict):
            raise ValueError("sweep templates need dict params (the table "
                             "overrides parameters by name)")
        if not table:
            raise ValueError("sweep table must name at least one parameter")
        names = tuple(sorted(table))
        missing = [n for n in names if n not in self.params]
        if missing:
            raise ValueError(
                f"sweep table names {missing} not in template params "
                f"{sorted(self.params)}")
        device = self.device
        cols = {n: _t(table[n].detach().cpu().numpy()
                      if isinstance(table[n], torch.Tensor) else table[n],
                      device) for n in names}
        n_points = {int(v.shape[0]) for v in cols.values()}
        if len(n_points) != 1:
            raise ValueError(
                f"sweep table axes disagree on n_points: "
                f"{ {n: int(v.shape[0]) for n, v in cols.items()} }")
        (n_pts,) = n_points
        for n in names:
            if tuple(cols[n].shape[1:]) != tuple(self.params[n].shape[1:]):
                raise ValueError(
                    f"sweep axis {n!r} has per-point shape "
                    f"{tuple(cols[n].shape[1:])}, template expects "
                    f"{tuple(self.params[n].shape[1:])}")
        base = tree_map(lambda leaf: leaf.expand((n_pts,) + tuple(leaf.shape[1:]))
                        .contiguous(), self.params)
        domains = self.domains.expand((n_pts,) + tuple(self.domains.shape[1:]))
        return IntegrandFamily(
            fn=swept_fn(self.fn), params={"base": base, "table": cols},
            domains=domains.contiguous(), name=f"{self.name}:sweep[{n_pts}]",
            kernel=self.kernel, swept=names).validate()

    def sweep_base(self) -> "IntegrandFamily":
        """The template-parameter view of a swept family: ``params`` is
        the broadcast base dict (every row the template point).  Kernel
        packers consume this; call it on the :meth:`inner` view of a
        compactified swept family.  Identity for other families."""
        if not self.swept:
            return self
        if self.compact:
            raise ValueError("call sweep_base() on the inner() view of a "
                             "compactified swept family")
        return IntegrandFamily(fn=self.fn, params=self.params["base"],
                               domains=self.domains, name=self.name,
                               kernel=self.kernel)

    def eval_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Evaluate all functions on their own sample blocks.

        Args:
          x: (n_fn, B, dim) sample points (already inside each box).
        Returns:
          (n_fn, B) values.
        """
        return self.fn(x, self.params)


@dataclasses.dataclass(frozen=True)
class MultiFunctionSpec:
    """An ordered collection of integrand families (the v5.1 workload)."""

    families: tuple[IntegrandFamily, ...]

    @classmethod
    def from_families(cls, families: Sequence[IntegrandFamily]) -> "MultiFunctionSpec":
        fams = tuple(f.validate() for f in families)
        if not fams:
            raise ValueError("need at least one family")
        return cls(families=fams)

    @property
    def n_fn_total(self) -> int:
        return sum(f.n_fn for f in self.families)

    def offsets(self) -> list[int]:
        """Global function-id offset of each family (for RNG counters)."""
        out, acc = [], 0
        for f in self.families:
            out.append(acc)
            acc += f.n_fn
        return out

    def to(self, device) -> "MultiFunctionSpec":
        return MultiFunctionSpec(families=tuple(f.to(device) for f in self.families))


def adapted_fn(fn):
    """The batched integrand of an adapted family: ``fn`` at the points
    the grid maps the uniforms to, times the map's Jacobian."""
    from repro_torch.core import adaptive

    def mapped(u, p):
        x, jac = adaptive.apply_map(u, p["grid"][:, None])
        return fn(x, p["inner"]) * jac

    return mapped


def swept_fn(fn):
    """The batched integrand of a swept family: ``fn`` on the base
    params with the table's entries merged over them."""

    def merged(x, p):
        return fn(x, {**p["base"], **p["table"]})

    return merged


def _t(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def _leaf(x, device) -> torch.Tensor:
    """Tensor of one parameter leaf: integer arrays (transform kinds) stay
    int32, everything else becomes float32."""
    arr = np.asarray(x)
    if arr.dtype.kind in "iub":
        return torch.from_numpy(arr.astype(np.int32)).to(device)
    return _t(arr, device)


def _box(n: int, dim: int, lo: float, hi: float, device) -> torch.Tensor:
    return _t(np.broadcast_to(np.asarray([lo, hi], np.float32), (n, dim, 2)), device)


# ---------------------------------------------------------------------------
# Stock families used across tests, examples and benchmarks.
# ---------------------------------------------------------------------------

def _harmonic_fn(x, p):
    phase = torch.sum(x * p["k"][:, None, :], dim=-1)
    return p["a"][:, None] * torch.cos(phase) + p["b"][:, None] * torch.sin(phase)


def harmonic_family(n: int, dim: int = 4, *, a=None, b=None, k=None,
                    lo: float = 0.0, hi: float = 1.0,
                    device="cpu") -> IntegrandFamily:
    """The paper's Fig.-1 family: f_n(x) = a_n cos(k_n.x) + b_n sin(k_n.x).

    Defaults reproduce the paper: a_n = b_n = 1,
    k_n = ((n+50)/(2*pi)) * (1,...,1), domain [0,1]^dim, n = 1..n.
    """
    idx = np.arange(1, n + 1, dtype=np.float32)
    if a is None:
        a = np.ones(n, np.float32)
    if b is None:
        b = np.ones(n, np.float32)
    if k is None:
        k = np.repeat(((idx + 50.0) / (2.0 * np.pi))[:, None], dim, axis=1)
    return IntegrandFamily(
        fn=_harmonic_fn,
        params={"a": _t(a, device), "b": _t(b, device), "k": _t(k, device)},
        domains=_box(n, dim, lo, hi, device),
        name=f"harmonic[{n}x{dim}d]",
        kernel="mc_eval_harmonic",
    ).validate()


def harmonic_analytic(n: int, dim: int = 4) -> np.ndarray:
    """Closed form of the paper's Fig.-1 integrals over [0,1]^dim:
    F_n = [cos(c d/2) + sin(c d/2)] * (sin(c/2)/(c/2))^d, c = (n+50)/(2 pi)."""
    idx = np.arange(1, n + 1, dtype=np.float64)
    c = (idx + 50.0) / (2.0 * np.pi)
    s = (np.sin(c / 2.0) / (c / 2.0)) ** dim
    return (np.cos(c * dim / 2.0) + np.sin(c * dim / 2.0)) * s


def _abs_sum_fn(x, p):
    return p["c"][:, None] * torch.abs(torch.sum(x * p["s"][:, None, :], dim=-1))


def abs_sum_family(n: int, dim: int, coeff, *, sign_last: float = 1.0,
                   lo: float = 0.0, hi: float = 1.0,
                   device="cpu") -> IntegrandFamily:
    """The paper's Eq.-(2) family: g_n(x) = c_n * |x_1 + x_2 (+/-) x_3 ...|."""
    coeff = np.asarray(coeff, np.float32).reshape(n)
    signs = np.ones(dim, np.float32)
    signs[-1] = sign_last
    return IntegrandFamily(
        fn=_abs_sum_fn,
        params={"c": _t(coeff, device),
                "s": _t(np.broadcast_to(signs, (n, dim)), device)},
        domains=_box(n, dim, lo, hi, device),
        name=f"abs_sum[{n}x{dim}d]",
        kernel="mc_eval_abs_sum",
    ).validate()


def gaussian_analytic(n: int, dim: int, *, sigma=None,
                      half: bool = False) -> np.ndarray:
    """Closed form of :func:`gaussian_family` over R^dim,
    ``(sigma sqrt(2 pi))^dim`` (over the positive orthant with ``half``)."""
    if sigma is None:
        sigma = np.linspace(0.5, 2.0, n)
    full = (np.asarray(sigma, np.float64) * np.sqrt(2.0 * np.pi)) ** dim
    return full / (2.0 ** dim) if half else full


def _gaussian_fn(x, p):
    return torch.exp(-0.5 * torch.sum(torch.square(x), dim=-1)
                     / torch.square(p["sigma"])[:, None])


def gaussian_family(n: int, dim: int, *, sigma=None, lo=-4.0, hi=4.0,
                    device="cpu") -> IntegrandFamily:
    """Product Gaussians exp(-|x|^2 / (2 sigma^2)) on [lo, hi]^dim."""
    if sigma is None:
        sigma = np.linspace(0.5, 2.0, n).astype(np.float32)
    sigma = np.asarray(sigma, np.float32).reshape(n)
    return IntegrandFamily(
        fn=_gaussian_fn,
        params={"sigma": _t(sigma, device)},
        domains=_box(n, dim, lo, hi, device),
        name=f"gaussian[{n}x{dim}d]",
        kernel="mc_eval_gaussian",
    ).validate()


def _kernel_fns() -> dict:
    from repro_torch.core import genz
    return {
        "mc_eval_harmonic": _harmonic_fn,
        "mc_eval_abs_sum": _abs_sum_fn,
        "mc_eval_gaussian": _gaussian_fn,
        "mc_eval_genz_osc": genz.oscillatory_fn,
        "mc_eval_genz_corner": genz.corner_peak_fn,
    }


def family_from_numpy(kernel: str | None, params: dict, domains, name: str,
                      *, fn=None, compact: bool = False,
                      swept: tuple[str, ...] = (),
                      device="cpu") -> IntegrandFamily:
    """A port family from a ``repro`` family's arrays.

    Args:
      kernel: the registered form name (``"mc_eval_harmonic"``, ...); it
        selects the batched PyTorch ``fn`` unless ``fn`` is given.
      params: ``{name: np.ndarray}`` with leading axis n_fn (nested dicts
        allowed).
      domains: (n_fn, dim, 2) array; may hold infinite edges.
      name: family label (keep ``repro``'s to share checkpoint tags).
      fn: batched ``fn(x, p)``; required when ``kernel`` is None.
      compact: the arrays are those of a ``repro`` family already
        compactified: ``params`` is ``{"inner": ..., "aux": {"kind",
        "shift"}}`` and ``domains`` the finite sampling box; ``fn`` (or
        the kernel's) is the pre-transform integrand.
      swept: the arrays are those of a ``repro`` swept family (its
        ``swept`` names): ``params`` (or ``params["inner"]``) is
        ``{"base": ..., "table": ...}``; ``fn`` (or the kernel's) is the
        template's integrand.
    """
    if fn is None:
        fns = _kernel_fns()
        if kernel not in fns:
            raise ValueError(f"no PyTorch function known for kernel {kernel!r}; "
                             f"pass fn= (known: {sorted(fns)})")
        fn = fns[kernel]
    if swept:
        fn = swept_fn(fn)
    return IntegrandFamily(
        fn=domains_lib.compactified_fn(fn) if compact else fn,
        params=tree_map(lambda v: _leaf(v, device), params),
        domains=_t(domains, device),
        name=name,
        kernel=kernel,
        compact=bool(compact),
        swept=tuple(swept),
    ).validate()


def spec_from_numpy(families: Sequence[dict], *, device="cpu") -> MultiFunctionSpec:
    """A spec from a list of :func:`family_from_numpy` keyword dicts
    (``kernel``, ``params``, ``domains``, ``name`` and optionally ``fn``)."""
    return MultiFunctionSpec.from_families(
        [family_from_numpy(device=device, **f) for f in families])
