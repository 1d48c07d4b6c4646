"""Kernel form registry with capability metadata (port of
``repro.kernels.registry``).

A :class:`KernelForm` is an eval body + param packer + capability
metadata.  Registering one generates its single-family impl from the
shared template (``repro_torch.kernels.template.make_family_impl``) and
makes it available to the fused multi-family planner
(``repro_torch.kernels.mc_eval.multi``).

Each form carries a ``form_id``: the index of its body in the CUDA
kernel's switch (``kernels/csrc/zmc_device.cuh``), which the plain
PyTorch version switches on too.

Dispatch entry points:

* :func:`register` — a bare callable under a name, without metadata.
* :func:`get` — name -> impl, raising on unknown names.
* :func:`lookup` — capability-checked: the impl if the named form
  supports (dim, sampler, compactified, sweep, adapted), else ``None``
  so the engine takes the chunked path.  This is what
  ``direct_mc._sums_with_ids`` calls.

Forms advertise both samplers (Sobol up to ``core.sobol.MAX_DIM``
dims) and the three wrapper stages: the compactification
(``supports_compactified``), the parameter sweep (``sweep_cols``) and
the importance grid (``supports_adapted``), as ``repro``'s forms do.
The pseudo-random impl owns the bare form name, the Sobol one
``"<name>@sobol"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

_REGISTRY: dict[str, Callable] = {}
_FORMS: dict[str, "KernelForm"] = {}
_BY_ID: dict[int, "KernelForm"] = {}

# dims addressable by the Threefry counter layout (rng.DIM_STRIDE)
_COUNTER_MAX_DIM = 256
# bodies compiled into the CUDA kernel (zmc::N_FORMS)
N_DEVICE_FORMS = 5


@dataclasses.dataclass(frozen=True)
class KernelForm:
    """Capability record for one integrand form's fused kernel.

    Attributes:
      name: registry name (also the ``IntegrandFamily.kernel`` tag).
      form_id: index of this form's body in the CUDA kernel.
      body: plain eval body ``body(draw, p, dim) -> (F, S) values``, where
        ``p`` is the (F, n_cols) packed block and ``draw(d)`` the (F, S)
        domain-mapped samples of dimension ``d``.
      pack_params: ``family -> f32[n_fn, n_cols(dim)]`` packed parameters.
      n_cols: ``dim -> int`` packed width (fused buckets pad to the max).
      max_dim: largest supported integrand dimension.
      samplers: supported samplers, a subset of ("mc", "sobol").
      backends: where the form runs ("cuda" kernel, "cpu" plain version).
      supports_compactified: whether the body composes with the
        compactification stage (the CUDA kernel's compactified blocks,
        ``template.compactified_body`` in the plain version).
      sweep_cols: ``dim -> {param name: base packed column indices}``:
        the template parameters a swept family's table may override per
        point, and the packed columns each occupies
        (``template.sweep_col_map``); ``None``: not sweepable.
      supports_adapted: whether the body composes with the
        importance-grid stage (the CUDA kernel's adapted blocks,
        ``template.adapted_body`` in the plain version) that serves
        adapted families (``IntegrandFamily.adapted``).
    """

    name: str
    form_id: int
    body: Callable
    pack_params: Callable
    n_cols: Callable[[int], int]
    max_dim: int = _COUNTER_MAX_DIM
    samplers: tuple[str, ...] = ("mc", "sobol")
    backends: tuple[str, ...] = ("cuda", "cpu")
    supports_compactified: bool = True
    sweep_cols: Callable[[int], dict[str, tuple[int, ...]]] | None = None
    supports_adapted: bool = True

    @property
    def supports_swept(self) -> bool:
        """Whether this form serves swept families at all."""
        return self.sweep_cols is not None

    def supports(self, *, dim: int, sampler: str = "mc",
                 compactified: bool = False, sweep: tuple[str, ...] = (),
                 adapted: bool = False) -> bool:
        if sampler not in self.samplers or not 1 <= dim <= self.max_dim:
            return False
        if compactified and not self.supports_compactified:
            return False
        if adapted and not self.supports_adapted:
            return False
        if sweep:
            if self.sweep_cols is None:
                return False
            if any(name not in self.sweep_cols(dim) for name in sweep):
                return False
        if sampler == "sobol":
            from repro_torch.core.sobol import MAX_DIM
            return dim <= MAX_DIM
        return True


def register(name: str):
    """Register a bare callable under ``name`` (no capability metadata);
    raises ``ValueError`` if the name is taken."""
    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"kernel {name!r} already registered")
        _REGISTRY[name] = fn
        return fn
    return deco


def register_form(form: KernelForm, *, validate: bool = True) -> KernelForm:
    """Register a form and generate its impl for every sampler it
    supports.

    By default the form's kernel contracts are proven eagerly BEFORE the
    registry mutates (:mod:`repro_torch.analysis.contracts`): the eval
    body must run pure and f32 under every advertised capability
    combination, and its outputs must match every already-registered
    form it would share a fused bucket with, so a contract-breaking form
    raises a ``ValueError`` naming the KCT rule here, at its definition
    site, instead of failing inside the fused kernel at first launch.
    Tests exercising deliberately broken forms pass ``validate=False``.
    """
    if form.name in _FORMS:
        raise ValueError(f"kernel form {form.name!r} already registered")
    if not set(form.samplers) <= {"mc", "sobol"}:
        raise ValueError(f"form {form.name!r}: unknown samplers "
                         f"{form.samplers}")
    if validate:
        from repro_torch.analysis.contracts import validate_form_registration
        validate_form_registration(form, _FORMS.values())
    if not 0 <= form.form_id < N_DEVICE_FORMS or form.form_id in _BY_ID:
        raise ValueError(
            f"form {form.name!r}: form_id {form.form_id} must be a free index "
            f"below {N_DEVICE_FORMS} (the CUDA kernel's bodies)")
    from repro_torch.kernels.template import make_family_impl
    _FORMS[form.name] = form
    _BY_ID[form.form_id] = form
    for sampler in form.samplers:
        _REGISTRY[impl_name(form.name, sampler)] = make_family_impl(form, sampler)
    return form


def impl_name(name: str, sampler: str) -> str:
    """Registry key of a form's impl for ``sampler``."""
    return name if sampler == "mc" else f"{name}@{sampler}"


def impl(name: str) -> Callable:
    """Plain dict lookup (no import side effect; registration-time use)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no kernel impl registered under {name!r}; have "
                       f"{sorted(_REGISTRY)} (sampler variants are named "
                       f"'<form>@<sampler>')") from None


def _load_builtin():
    # import for side effect: kernel modules self-register
    import repro_torch.kernels.mc_eval.ops  # noqa: F401


def get(name: str) -> Callable:
    _load_builtin()
    if name not in _REGISTRY:
        raise KeyError(f"no kernel named {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def form(name: str) -> KernelForm | None:
    """The KernelForm registered under ``name``, or None."""
    _load_builtin()
    return _FORMS.get(name.split("@", 1)[0])


def by_id(form_id: int) -> KernelForm:
    """The form whose body sits at ``form_id`` in the kernel's switch."""
    _load_builtin()
    try:
        return _BY_ID[int(form_id)]
    except KeyError:
        raise KeyError(f"no kernel form with form_id {form_id}; have "
                       f"{sorted(_BY_ID)}") from None


def lookup(name: str, *, dim: int, sampler: str = "mc",
           compactified: bool = False, sweep: tuple[str, ...] = (),
           adapted: bool = False, required: bool = False) -> Callable | None:
    """Capability-checked dispatch: impl for (dim, sampler, compactified,
    sweep, adapted) or None.  ``sweep`` names the parameters a swept
    family's table overrides; ``adapted`` marks a family carrying an
    importance grid (``IntegrandFamily.adapt_bins``).

    ``required=True`` turns the None into a ``ValueError`` naming the
    form, the request and what the form supports (the sweep engine has
    no fallback and asks for this).
    """
    _load_builtin()
    f = _FORMS.get(name)
    if f is not None and f.supports(dim=dim, sampler=sampler,
                                    compactified=compactified, sweep=sweep,
                                    adapted=adapted):
        return _REGISTRY[impl_name(name, sampler)]
    if required:
        if f is None:
            have = f"registered forms: {sorted(_FORMS)}"
        else:
            from repro_torch.core.sobol import MAX_DIM
            have = (f"form supports dim<={f.max_dim}, samplers={f.samplers}"
                    f" (sobol dim<={MAX_DIM})"
                    + (", compactified ok" if f.supports_compactified else "")
                    + (", adapted ok" if f.supports_adapted else "")
                    + (f", sweepable={sorted(f.sweep_cols(min(dim, f.max_dim)))}"
                       if f.sweep_cols is not None else ""))
        raise ValueError(f"kernel lookup missed for {name!r} "
                         f"(dim={dim}, sampler={sampler!r}, "
                         f"compactified={compactified}, sweep={tuple(sweep)}, "
                         f"adapted={adapted}): "
                         f"{have}")
    return None


def names() -> list[str]:
    _load_builtin()
    return sorted(_REGISTRY)


def forms() -> list[KernelForm]:
    _load_builtin()
    return [_FORMS[k] for k in sorted(_FORMS)]
