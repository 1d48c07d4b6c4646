"""Public request/response surface of the integration service (port of
``repro.service.api``).

A request names *what* to integrate and *how well*: a sample budget, a
standard-error target, or both.  The engine decides everything else —
batching, caching, counter-space placement, kernel dispatch.  Two
request shapes exist:

* :class:`IntegrationRequest` — a list of
  :class:`~repro_torch.core.integrand.IntegrandFamily`;
* :class:`SweepRequest` — ONE single-function template family x a
  parameter grid.  The service canonicalizes the grid into fixed-size
  slices of swept families (``canonical.sweep_slices``), so a large scan
  costs slice-count cache entries and one fused launch per (dim,
  sampler) bucket per wave, and overlapping sweeps share streams at the
  sub-grid level.  Results stream back per point as rounds complete
  (``engine.sweep_partial``).

Both take ``sampler="mc"`` or ``"sobol"``.  An
:class:`IntegrationRequest` with ``adaptive=True`` and a
``target_stderr`` samples through a VEGAS importance grid the engine
fits and refits per stream (``repro_torch.core.adaptive``).

``IntegrationClient`` is the blocking convenience wrapper: it submits,
drives the engine if no background worker is running, and returns the
finished result.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.integrand import IntegrandFamily, MultiFunctionSpec


class Backpressure(RuntimeError):
    """Raised by non-blocking submit when the pending table is full."""


class RequestError(RuntimeError):
    """Raised by the blocking client when a ticket completed as a
    :class:`RequestFailed`; carries the structured failure as
    ``.failure``."""

    def __init__(self, failure: "RequestFailed"):
        super().__init__(
            f"request {failure.ticket} failed ({failure.reason}"
            f"{f', stage {failure.stage}' if failure.stage else ''}): "
            f"{failure.message}")
        self.failure = failure


@dataclasses.dataclass(frozen=True)
class IntegrationRequest:
    """One client ask: evaluate these families to this precision.

    Attributes:
      families: the integrands; a ``MultiFunctionSpec`` is accepted too.
      n_samples: minimum sample budget per function (quantized up to the
        engine's round size).
      target_stderr: serve once every function's standard error is at or
        below this.  With both set, both must hold.
      sampler: "mc" | "sobol" — selects the sample stream (and therefore
        the cache entry: the two streams never mix).
      deadline: optional wall-time budget in seconds, measured from
        submit.  When it expires before the precision is reached the
        ticket *completes* with a :class:`RequestFailed` (reason
        ``"deadline"``) instead of hanging; retry backoff sleeps are
        clamped to the remaining budget.
      adaptive: opt in to VEGAS importance-grid adaptation: the engine
        fits a per-stream grid from a deterministic pilot and refits it
        between waves while the stderr target is unmet, each epoch a new
        cache stream.  Honoured only with a ``target_stderr`` (a sample
        budget has nothing to adapt toward, so the flag is ignored) and
        on non-swept families.
    """

    families: tuple[IntegrandFamily, ...]
    n_samples: int | None = None
    target_stderr: float | None = None
    sampler: str = "mc"
    deadline: float | None = None
    adaptive: bool = False

    @classmethod
    def make(cls, families: Sequence[IntegrandFamily] | MultiFunctionSpec,
             *, n_samples: int | None = None,
             target_stderr: float | None = None,
             sampler: str = "mc",
             deadline: float | None = None,
             adaptive: bool = False) -> "IntegrationRequest":
        if isinstance(families, MultiFunctionSpec):
            families = families.families
        families = tuple(f.validate() for f in families)
        if not families:
            raise ValueError("request needs at least one family")
        if n_samples is None and target_stderr is None:
            raise ValueError("request needs n_samples or target_stderr")
        if n_samples is not None and n_samples <= 0:
            raise ValueError("n_samples must be positive")
        if target_stderr is not None and target_stderr <= 0:
            raise ValueError("target_stderr must be positive")
        if sampler not in ("mc", "sobol"):
            raise ValueError(f"unknown sampler {sampler!r}")
        if deadline is not None and deadline <= 0:
            raise ValueError("deadline must be positive (seconds)")
        return cls(families=families, n_samples=n_samples,
                   target_stderr=target_stderr, sampler=sampler,
                   deadline=deadline, adaptive=bool(adaptive))


def request_from_numpy(families: Sequence[dict], *, device="cpu",
                       **kwargs) -> IntegrationRequest:
    """A port request from the arrays of a ``repro`` request's families.

    ``families`` holds one :func:`~repro_torch.core.integrand.family_from_numpy`
    keyword dict per family (``kernel``, ``params``, ``domains``, ``name``
    and optionally ``fn`` and ``compact``); ``kwargs`` are those of
    :meth:`IntegrationRequest.make` (``n_samples``, ``target_stderr``,
    ``deadline``, ...).  Both packages then serve the same integrals
    under the same stream ids.
    """
    from repro_torch.core.integrand import family_from_numpy
    return IntegrationRequest.make(
        [family_from_numpy(device=device, **f) for f in families], **kwargs)


@dataclasses.dataclass(frozen=True)
class SweepRequest:
    """One client ask: scan a template integrand over a parameter grid.

    Attributes:
      template: a single-function (``n_fn == 1``) family whose dict
        params the grid overrides by name.
      grid: ``{param name: axis values}``; the swept points are the
        row-major cartesian product over axes in sorted-name order (last
        axis fastest).  Axis values may be vectors per point (e.g. a
        dim-wide ``k``): the leading axis is the point axis.
      n_samples / target_stderr / sampler / deadline: as on
        :class:`IntegrationRequest`, applied to every grid point.
    """

    template: IntegrandFamily
    grid: dict
    n_samples: int | None = None
    target_stderr: float | None = None
    sampler: str = "mc"
    deadline: float | None = None

    @classmethod
    def make(cls, template: IntegrandFamily, grid: dict, *,
             n_samples: int | None = None,
             target_stderr: float | None = None,
             sampler: str = "mc",
             deadline: float | None = None) -> "SweepRequest":
        template = template.validate()
        if template.n_fn != 1:
            raise ValueError(
                f"sweep template must be a single function (n_fn == 1); "
                f"got n_fn={template.n_fn}")
        if not isinstance(template.params, dict):
            raise ValueError("sweep template needs dict params")
        if not grid:
            raise ValueError("sweep grid must name at least one axis")
        missing = [k for k in grid if k not in template.params]
        if missing:
            raise ValueError(f"sweep grid names {sorted(missing)} not in "
                             f"template params {sorted(template.params)}")
        if n_samples is None and target_stderr is None:
            raise ValueError("request needs n_samples or target_stderr")
        if n_samples is not None and n_samples <= 0:
            raise ValueError("n_samples must be positive")
        if target_stderr is not None and target_stderr <= 0:
            raise ValueError("target_stderr must be positive")
        if sampler not in ("mc", "sobol"):
            raise ValueError(f"unknown sampler {sampler!r}")
        if deadline is not None and deadline <= 0:
            raise ValueError("deadline must be positive (seconds)")
        return cls(template=template, grid=dict(grid), n_samples=n_samples,
                   target_stderr=target_stderr, sampler=sampler,
                   deadline=deadline)


@dataclasses.dataclass(frozen=True)
class IntegrationResult:
    """Finished estimates, in the request's family-by-family order."""

    means: np.ndarray            # (n_fn_total,)
    stderrs: np.ndarray          # (n_fn_total,)
    n_per_family: tuple[int, ...]  # samples accumulated per family stream
    names: tuple[str, ...]
    served_from_cache: bool      # True -> zero new launches were needed
    ticket: int
    # cache stream ids backing each family, in request order; keys for
    # engine.stderr_trajectory() / the /convergence exposition
    stream_ids: tuple[str, ...] = ()

    @property
    def n_fn_total(self) -> int:
        return int(self.means.shape[0])

    @property
    def failed(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class RequestFailed:
    """Terminal failure of a ticket — a *completed* result, not a hang.

    Produced by the engine when a request can no longer succeed: its
    wave's retry budget is exhausted (``reason="retry_exhausted"``), its
    deadline ran out (``"deadline"``), or every path to it runs through
    a quarantined stream (``"quarantined"``).  Polling/result calls
    return it like any result; the blocking client raises
    :class:`RequestError` around it.
    """

    ticket: int
    reason: str                      # retry_exhausted | deadline | quarantined
    stage: str | None = None         # pipeline stage that exhausted, if any
    attempts: int = 0                # attempts the retry policy ran
    message: str = ""
    stream_ids: tuple[str, ...] = ()

    @property
    def failed(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class SweepResult(IntegrationResult):
    """Per-point estimates of a sweep, in row-major grid order.

    ``means``/``stderrs`` are flat over grid points; reshape to
    ``grid_shape`` to index by axis value (``axis_names`` gives the axis
    order: sorted parameter names).  ``n_per_family`` / ``names`` /
    ``stream_ids`` are per canonical *slice*, the unit the cache keys on.
    A partial snapshot (``engine.sweep_partial``) carries
    ``complete=False`` and a ``points_done`` mask over points whose slice
    has at least one finished round (undone points hold NaN means and inf
    stderrs).
    """

    grid_shape: tuple[int, ...] = ()
    axis_names: tuple[str, ...] = ()
    n_points: int = 0
    points_done: np.ndarray | None = None
    complete: bool = True


class IntegrationClient:
    """Blocking client over an :class:`~repro_torch.service.engine.IntegrationEngine`.

    When the engine runs a background worker, ``integrate`` just waits;
    otherwise it drives ``engine.step()`` itself — handy for tests,
    benchmarks and single-process batch jobs where determinism matters.

    Usable as a context manager: ``with IntegrationClient(engine) as c:``
    closes the engine on exit — for an engine with a ``state_dir`` that
    is the snapshot-on-shutdown path (journal compacted into one npz).
    """

    def __init__(self, engine):
        self.engine = engine

    def close(self) -> None:
        """Shut the engine down cleanly (snapshots persistent state)."""
        self.engine.close()

    def __enter__(self) -> "IntegrationClient":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def submit(self, families, **kwargs) -> int:
        return self.engine.submit(IntegrationRequest.make(families, **kwargs))

    def integrate(self, families, **kwargs) -> IntegrationResult:
        ticket = self.submit(families, **kwargs)
        return self.wait(ticket)

    def submit_sweep(self, template, grid, **kwargs) -> int:
        return self.engine.submit(SweepRequest.make(template, grid, **kwargs))

    def sweep(self, template, grid, **kwargs) -> SweepResult:
        """Scan ``template`` over ``grid`` and block for every point."""
        ticket = self.submit_sweep(template, grid, **kwargs)
        return self.wait(ticket)

    def sweep_partial(self, ticket: int,
                      since: np.ndarray | None = None) -> SweepResult:
        """Current per-point snapshot of an in-flight sweep (non-blocking);
        ``since``, the previous snapshot's ``points_done``, limits the
        work to newly finished points (see ``engine.sweep_partial``)."""
        return self.engine.sweep_partial(ticket, since=since)

    def wait(self, ticket: int, timeout: float | None = None) -> IntegrationResult:
        if self.engine.running:
            return self._unwrap(self.engine.result(ticket, timeout=timeout))
        from repro_torch.service.resilience import (DeadlineExceeded,
                                              RetryExhausted)
        while (res := self.engine.poll(ticket)) is None:
            try:
                stepped = self.engine.step()
            except (RetryExhausted, DeadlineExceeded):
                # the wave this step drove failed permanently; its riders
                # (possibly including our ticket) were completed as
                # RequestFailed — keep driving the remaining pendings
                continue
            if not stepped:
                res = self.engine.poll(ticket)
                if res is None:
                    raise RuntimeError(f"ticket {ticket} cannot make progress")
                return self._unwrap(res)
        return self._unwrap(res)

    @staticmethod
    def _unwrap(res):
        if isinstance(res, RequestFailed):
            raise RequestError(res)
        return res
