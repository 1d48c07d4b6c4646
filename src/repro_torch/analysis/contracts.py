"""Layer 2: contract checker for registered kernel forms (port of
``repro.analysis.contracts``).

The fused launch path makes promises it cannot check cheaply at launch
time:

* eval bodies are **pure** — a body that syncs with the host, copies off
  the device or draws from a stateful RNG would make per-round sums
  depend on execution order (or stall the card), breaking the WAL's
  bit-exact replay (KCT001);
* bodies accumulate in **float32** — the ``(s1, s2)`` deposit dtype the
  journal stores exactly (KCT002);
* all bodies fused into one ``(dim, sampler)`` bucket produce
  **identical outputs** — the plain version writes each group's values
  into one f32 ``(F, S)`` block and the CUDA kernel switches between
  bodies per function block (KCT003);
* a form advertising ``supports_compactified=True`` really does compose
  with ``template.compactified_body`` (KCT004), one declaring
  ``sweep_cols`` with ``template.swept_body`` (KCT005) and one
  advertising ``supports_adapted=True`` with ``template.adapted_body``
  (KCT006).

The reference proves these by tracing jaxprs.  Here each registered
:class:`~repro_torch.kernels.registry.KernelForm` body runs on the
zero-filled probe operands of :func:`repro_torch.kernels.template
.probe_operands` for every capability combination it advertises (sampler
x finite/compactified x plain/swept x plain/adapted, over a probe dim
sweep; the engine never builds swept+adapted streams, so that
combination is not probed), while a ``TorchFunctionMode`` and a
``TorchDispatchMode`` record every call and op.  The probes are CPU
tensors, not ``"meta"`` ones: a body never sees the values (the findings
come from the recorded calls and the outputs' shapes and dtypes), and
torch's Python meta kernels cost 0.1-1.4 ms per op plus seconds of
warm-up per process, which the registration of the builtin forms at
import would pay in every process (4.4 s against 0.35 s for every
builtin combination, on the CPU).  No kernel is launched and no card is
needed.

:func:`validate_form_registration` packages the same predicates for
eager use at registration time (``registry.register_form``), so a
contract-breaking form raises a named exception where it is defined
instead of failing inside the fused kernel at first launch.
"""

from __future__ import annotations

import functools
import inspect

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.violations import Violation
from repro_torch.kernels import template

# Dimensions each form is probed at: the low dims the paper's example
# suite lives in plus one mid-size dim; each is clipped to the form's
# advertised max_dim (and the Sobol table limit for sampler="sobol").
PROBE_DIMS = (1, 2, 4)

# Importance-grid bins used when probing adapted combos (KCT006); the
# composition is bin-count independent (the column layout is the only
# thing that scales).
PROBE_BINS = 4

# The probe device (see the module docstring for why not "meta").
PROBE_DEVICE = "cpu"

# Tensor methods that hand a value to the host or move a tensor off the
# card (each waits for it).  The recorder answers them with a stand-in so
# the run goes on and the body's other contracts are still checked.
_HOST_METHODS = {
    "item": lambda t: 0.0,
    "__bool__": lambda t: False,
    "__float__": lambda t: 0.0,
    "__int__": lambda t: 0,
    "__index__": lambda t: 0,
    "tolist": lambda t: np.zeros(tuple(t.shape)).tolist(),
    "numpy": lambda t: np.zeros(tuple(t.shape), np.float32),
    "cpu": lambda t: t,
    "cuda": lambda t: t,
}


class _Recorder(TorchFunctionMode):
    """Records every impure call a body makes (KCT001) as it runs.

    Python-level host syncs and device moves are caught here, by method
    name, and ``Tensor.to`` with an explicit device (on the card every
    body tensor already is where it belongs); op-level ones
    (``aten._local_scalar_dense``, any op tagged ``nondeterministic_seeded``
    or ``dynamic_output_shape``) by :class:`_OpRecorder`.
    """

    def __init__(self):
        super().__init__()
        self.events: list[str] = []
        self.ops = _OpRecorder(self.events)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if args and isinstance(args[0], torch.Tensor):
            if name in _HOST_METHODS:
                self.events.append(f"host sync Tensor.{name}()")
                return _HOST_METHODS[name](args[0])
            if name == "to" and _names_device(args[1:], kwargs):
                self.events.append("copy to another device Tensor.to(device)")
                return args[0]
        return func(*args, **kwargs)

    def __enter__(self):
        super().__enter__()
        self.ops.__enter__()
        return self

    def __exit__(self, *exc):
        self.ops.__exit__(*exc)
        return super().__exit__(*exc)


def _names_device(args, kwargs) -> bool:
    return any(isinstance(a, (str, torch.device, torch.Tensor))
               for a in (*args, kwargs.get("device")))


class _OpRecorder(TorchDispatchMode):
    def __init__(self, events: list[str]):
        super().__init__()
        self.events = events

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing is compiled under the recorder; torch's default wraps the
        # handler in dynamo's disable, whose first call imports
        # torch._dynamo (2 s on the CPU) in every process
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if func is torch.ops.aten._local_scalar_dense.default:
            self.events.append("host sync aten._local_scalar_dense")
        if torch.Tag.nondeterministic_seeded in func.tags:
            self.events.append(f"random op aten.{name}")
        if torch.Tag.dynamic_output_shape in func.tags:
            self.events.append(f"host sync aten.{name} (data-dependent "
                               "output shape)")
        return func(*args, **(kwargs or {}))


def _body_location(body) -> tuple[str, int]:
    """(file, line) of an eval body, for violation labelling."""
    try:
        code = getattr(body, "__wrapped__", body).__code__
        return code.co_filename.replace("\\", "/"), code.co_firstlineno
    except AttributeError:
        try:
            path = inspect.getsourcefile(body) or "<unknown>"
            _, line = inspect.getsourcelines(body)
            return path.replace("\\", "/"), line
        except (OSError, TypeError):
            return "<unknown>", 0


@functools.lru_cache(maxsize=512)
def _trace_body(body, dim: int, n_cols: int):
    """(outputs, impure events) of ``body`` on the probe operands.

    ``outputs`` is a tuple of ``(shape, dtype)`` per returned tensor (a
    non-tensor result counts as shape ``None``).  lru_cached on body
    identity: registration-time validation re-runs each registered body
    against every newcomer sharing a bucket.  Raises what the body
    raises, unless it made an impure call first: then the events are
    the finding and the outputs are empty.
    """
    draws, packed = template.probe_operands(dim, n_cols, device=PROBE_DEVICE)
    rec = _Recorder()
    try:
        with rec:
            out = body(lambda d: draws[d], packed, dim)
    except Exception:
        if rec.events:
            return (), tuple(rec.events)
        raise
    outs = out if isinstance(out, (tuple, list)) else (out,)
    avals = tuple((tuple(o.shape), str(o.dtype).replace("torch.", ""))
                  if isinstance(o, torch.Tensor)
                  else (None, type(o).__name__) for o in outs)
    return avals, tuple(rec.events)


def _probe_dims(form, sampler: str) -> list[int]:
    return [dim for dim in PROBE_DIMS
            if form.supports(dim=dim, sampler=sampler)]


def _full_sweep(form, dim: int) -> tuple[str, ...]:
    """The widest sweep the form advertises at ``dim`` — every name in
    its ``sweep_cols`` map, sorted (the order ``swept_over`` produces).
    Probing the full set subsumes every subset."""
    if form.sweep_cols is None:
        return ()
    return tuple(sorted(form.sweep_cols(dim)))


def _combos(form):
    """Every advertised capability combination: (sampler, compactified,
    swept, adapted, dim) tuples the form claims to support.  ``swept``
    probes the form's full ``sweep_cols`` name set (or stays ``()``);
    ``adapted`` is probed only for non-swept combos, mirroring the
    engine (adapted streams are never swept)."""
    out = []
    for sampler in form.samplers:
        for compact in (False, True):
            if compact and not form.supports_compactified:
                continue
            for dim in _probe_dims(form, sampler):
                for swept in ({(), _full_sweep(form, dim)} if
                              form.supports_swept else {()}):
                    adapt_axis = ((False, True) if
                                  form.supports_adapted and not swept
                                  else (False,))
                    for adapted in adapt_axis:
                        if form.supports(dim=dim, sampler=sampler,
                                         compactified=compact, sweep=swept,
                                         adapted=adapted):
                            out.append((sampler, compact, swept, adapted,
                                        dim))
    return sorted(out)


def _body_for(form, compact: bool, dim: int, swept: tuple[str, ...] = (),
              adapt_bins: int = 0):
    """(body, n_cols) the launch path would use for this combo, composed
    as ``template.body_and_packed`` composes it:
    ``adapted(compactified(swept(body)))`` over
    ``[base][sweep][adapt][transform]`` columns."""
    body, n_cols = form.body, form.n_cols(dim)
    if swept:
        cols = form.sweep_cols(dim)
        col_map = tuple(int(c) for name in swept for c in cols[name])
        body = template.swept_body(body, n_cols, col_map)
        n_cols += len(col_map)
    adapt_len = dim * (adapt_bins + 1) if adapt_bins else 0
    if compact:
        body = template.compactified_body(body, n_cols + adapt_len)
    if adapt_bins:
        body = template.adapted_body(body, n_cols, adapt_bins)
    n_cols += adapt_len
    if compact:
        n_cols += 2 * dim
    return body, n_cols


def _stage_rule(compact: bool, swept, adapted: bool, plain: str) -> str:
    return ("KCT006" if adapted else "KCT005" if swept else
            "KCT004" if compact else plain)


def check_form(form) -> list[Violation]:
    """KCT001/KCT002/KCT004/KCT005/KCT006 for one form, over every
    advertised combo."""
    found: list[Violation] = []
    path, line = _body_location(form.body)
    expect = ((template.F_BLK, template.S_BLK),)
    seen: set[tuple] = set()
    for sampler, compact, swept, adapted, dim in _combos(form):
        combo_key = (compact, swept, adapted, dim)  # bodies are sampler-independent
        if combo_key in seen:
            continue
        seen.add(combo_key)
        adapt_bins = PROBE_BINS if adapted else 0
        body, n_cols = _body_for(form, compact, dim, swept, adapt_bins)
        label = (f"{form.name}[dim={dim}"
                 + (", compactified" if compact else "")
                 + (f", swept={','.join(swept)}" if swept else "")
                 + (", adapted" if adapted else "") + "]")
        try:
            avals, events = _trace_body(body, dim, n_cols)
        except Exception as exc:  # noqa: BLE001 - any failure to run is the finding
            found.append(Violation(
                rule=_stage_rule(compact, swept, adapted, "KCT001"),
                path=path, line=line,
                message=f"{label} fails to run on probe operands: {exc}"))
            continue
        for event in dict.fromkeys(events):
            found.append(Violation(
                rule="KCT001", path=path, line=line,
                message=f"{label} makes an impure call: {event}"))
        if not avals:
            continue            # stopped by an impure call, reported above
        for _, dtype in avals:
            if dtype != "float32":
                found.append(Violation(
                    rule="KCT002", path=path, line=line,
                    message=f"{label} accumulates in {dtype} (the (s1, s2) "
                            "deposit contract is float32)"))
        shapes = tuple(shape for shape, _ in avals)
        if shapes != expect:
            found.append(Violation(
                rule=_stage_rule(compact, swept, adapted, "KCT002"),
                path=path, line=line,
                message=f"{label} returns outputs shaped {list(shapes)}, "
                        f"expected one {expect[0]} block (F_BLK functions "
                        "x S_BLK samples)"))
    return found


def bucket_avals(form, sampler: str, dim: int):
    """Outputs ((shape, dtype) per tensor) of the (body, packed width)
    the fused planner would put in the (dim, sampler) bucket for this
    form's *finite* families.  None if the form does not run cleanly
    (check_form reports that)."""
    body, n_cols = _body_for(form, False, dim)
    try:
        avals, events = _trace_body(body, dim, n_cols)
    except Exception:  # noqa: BLE001
        return None
    return avals if avals else None


def check_bucket_uniformity(forms) -> list[Violation]:
    """KCT003: identical outputs across all forms sharing a
    (dim, sampler) bucket — the precondition of writing every group's
    values into one f32 block (and of the kernel's per-block switch)."""
    found: list[Violation] = []
    buckets: dict[tuple, list] = {}
    for form in forms:
        for sampler in form.samplers:
            for dim in _probe_dims(form, sampler):
                buckets.setdefault((dim, sampler), []).append(form)
    for (dim, sampler), members in sorted(buckets.items()):
        sigs = []
        for form in members:
            avals = bucket_avals(form, sampler, dim)
            if avals is not None:
                sigs.append((form, avals))
        if len({avals for _, avals in sigs}) <= 1:
            continue
        majority = max(sorted({avals for _, avals in sigs}),
                       key=lambda a: sum(1 for _, x in sigs if x == a))
        for form, avals in sigs:
            if avals != majority:
                path, line = _body_location(form.body)
                found.append(Violation(
                    rule="KCT003", path=path, line=line,
                    message=f"{form.name} produces avals {avals} in the "
                            f"(dim={dim}, sampler={sampler!r}) bucket; "
                            f"other bucket members produce {majority} — "
                            "bodies fused into one bucket (one f32 block, "
                            "the kernel's per-block body switch) must "
                            "match"))
    return found


def check_forms(forms) -> list[Violation]:
    """All Layer-2 rules over an explicit form collection."""
    found: list[Violation] = []
    for form in forms:
        found.extend(check_form(form))
    found.extend(check_bucket_uniformity(forms))
    return found


def check_registered_forms() -> list[Violation]:
    """All Layer-2 rules over every registered form (CI entry point):
    every (sampler, compactified, swept, adapted, probe-dim) combination
    each form advertises, and every (dim, sampler) bucket they induce."""
    from repro_torch.kernels import registry
    return check_forms(registry.forms())


def validate_form_registration(form, existing) -> None:
    """Eager registration-time gate: raise ValueError if ``form`` breaks
    a kernel contract on its own or against already-registered forms.

    Called by ``registry.register_form`` before the registry mutates, so
    a bad form never becomes visible.  ``existing`` is the iterable of
    already-registered KernelForms to check bucket uniformity against.
    """
    own = check_form(form)
    if own:
        raise ValueError(
            f"kernel form {form.name!r} violates kernel contracts:\n"
            + "\n".join(str(v) for v in own))
    for sampler in form.samplers:
        for dim in _probe_dims(form, sampler):
            new_avals = bucket_avals(form, sampler, dim)
            if new_avals is None:
                continue
            for other in existing:
                if sampler not in other.samplers or not other.supports(
                        dim=dim, sampler=sampler):
                    continue
                other_avals = bucket_avals(other, sampler, dim)
                if other_avals is not None and other_avals != new_avals:
                    raise ValueError(
                        f"kernel form {form.name!r} produces output avals "
                        f"{new_avals} in the (dim={dim}, "
                        f"sampler={sampler!r}) bucket, but registered form "
                        f"{other.name!r} produces {other_avals}: bodies "
                        "fused into one bucket must produce identical "
                        "outputs [KCT003]")
