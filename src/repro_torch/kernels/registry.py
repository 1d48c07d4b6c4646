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

* :func:`get` — name -> impl, raising on unknown names.
* :func:`lookup` — capability-checked: the impl if the named form
  supports (dim, sampler), else ``None`` so the engine takes the chunked
  path.  This is what ``direct_mc._sums_with_ids`` calls.

Forms of this slice advertise ``samplers=("mc",)`` and, of the wrapper
stages, the compactification (``supports_compactified``, as ``repro``'s
forms do); swept and adapted come with later slices.
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
      samplers: supported samplers.
      backends: where the form runs ("cuda" kernel, "cpu" plain version).
      supports_compactified: whether the body composes with the
        compactification stage (the CUDA kernel's compactified blocks,
        ``template.compactified_body`` in the plain version).
      supports_adapted, sweep_cols: the other wrapper stages; not ported
        yet, so no form may claim them.
    """

    name: str
    form_id: int
    body: Callable
    pack_params: Callable
    n_cols: Callable[[int], int]
    max_dim: int = _COUNTER_MAX_DIM
    samplers: tuple[str, ...] = ("mc",)
    backends: tuple[str, ...] = ("cuda", "cpu")
    supports_compactified: bool = True
    sweep_cols: Callable[[int], dict[str, tuple[int, ...]]] | None = None
    supports_adapted: bool = False

    def supports(self, *, dim: int, sampler: str = "mc",
                 compactified: bool = False) -> bool:
        if compactified and not self.supports_compactified:
            return False
        return sampler in self.samplers and 1 <= dim <= self.max_dim


def register_form(form: KernelForm) -> KernelForm:
    """Register a form and generate its single-family impl."""
    if form.name in _FORMS:
        raise ValueError(f"kernel form {form.name!r} already registered")
    if form.sweep_cols is not None or form.supports_adapted:
        raise ValueError(f"form {form.name!r}: the swept and adapted stages "
                         "are not ported yet (ROADMAP queue 1 item 9)")
    if not 0 <= form.form_id < N_DEVICE_FORMS or form.form_id in _BY_ID:
        raise ValueError(
            f"form {form.name!r}: form_id {form.form_id} must be a free index "
            f"below {N_DEVICE_FORMS} (the CUDA kernel's bodies)")
    from repro_torch.kernels.template import make_family_impl
    _FORMS[form.name] = form
    _BY_ID[form.form_id] = form
    _REGISTRY[form.name] = make_family_impl(form)
    return form


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
           compactified: bool = False,
           required: bool = False) -> Callable | None:
    """Capability-checked dispatch: impl for (dim, sampler, compactified)
    or None.

    ``required=True`` turns the None into a ``ValueError`` naming the
    form, the request and what the form supports.
    """
    _load_builtin()
    f = _FORMS.get(name)
    if f is not None and f.supports(dim=dim, sampler=sampler,
                                    compactified=compactified):
        return _REGISTRY[name]
    if required:
        have = (f"form supports dim<={f.max_dim}, samplers={f.samplers}"
                + (", compactified ok" if f.supports_compactified else "")
                if f is not None else f"registered forms: {sorted(_FORMS)}")
        raise ValueError(f"kernel lookup missed for {name!r} "
                         f"(dim={dim}, sampler={sampler!r}, "
                         f"compactified={compactified}): {have}")
    return None


def names() -> list[str]:
    _load_builtin()
    return sorted(_REGISTRY)


def forms() -> list[KernelForm]:
    _load_builtin()
    return [_FORMS[k] for k in sorted(_FORMS)]
