"""``examples/service_quickstart_torch.py`` on the CPU against the reference
script's requests served by repro's engine on its chunked path
(``use_kernel=False``, as tests/test_torch_service.py holds the two
engines): every stage's result with the same names, stream ids and
samples per family, its estimates within repro's MC bound (rtol=5e-5,
atol=5e-3), and the six launch counts the reference script prints on the
CPU (cold 2, warm 0, top-up 1, infinite domain 1 with no fallback round,
sweep 1, sweep top-up 1) through the fused kernel's plain version.
"""

import contextlib
import importlib.util
import io
import re
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import gaussian_family, harmonic_family
from repro.service import IntegrationClient as JClient
from repro.service import IntegrationEngine as JEngine

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 5e-5, 5e-3
LAUNCHES = {"cold": 2, "warm": 0, "top_up": 1, "infinite": 1, "sweep": 1, "sweep_top_up": 1}
GRID = {"a": np.linspace(0.5, 2.0, 8), "b": np.linspace(-1.0, 1.0, 8)}


def _reference_tour() -> dict:
    """The reference script's requests, stage by stage, on repro's chunked
    engine (no telemetry bundle: it changes no result)."""
    out = {}
    client = JClient(JEngine(seed=0, round_samples=8192, use_kernel=False))
    out["a"] = client.integrate([harmonic_family(50, 4), gaussian_family(10, 3)],
                                n_samples=32768)
    out["b"] = client.integrate([harmonic_family(50, 4)], n_samples=32768)
    out["c"] = client.integrate([harmonic_family(50, 4)], n_samples=32768)
    out["d"] = client.integrate([harmonic_family(50, 4)], n_samples=65536)
    out["e"] = client.integrate([harmonic_family(50, 4)], target_stderr=2.5e-3)
    out["inf"] = client.integrate([gaussian_family(10, 3, lo=-np.inf, hi=np.inf)],
                                  n_samples=32768)
    with tempfile.TemporaryDirectory(prefix="zmc-state-") as state_dir:
        for key in ("restart_cold", "restart_warm"):
            with JEngine(seed=1, round_samples=8192, use_kernel=False,
                         state_dir=state_dir) as eng:
                out[key] = JClient(eng).integrate([harmonic_family(50, 4)], n_samples=32768)
    out["telemetry"] = JClient(JEngine(seed=2, round_samples=8192, use_kernel=False)).integrate(
        [harmonic_family(50, 4)], n_samples=65536)
    sweeper = JClient(JEngine(seed=3, round_samples=8192, use_kernel=False))
    out["sweep"] = sweeper.sweep(harmonic_family(1, 3), GRID, n_samples=16384)
    out["sweep_finer"] = sweeper.sweep(harmonic_family(1, 3), GRID, n_samples=65536)
    out["sweep_again"] = sweeper.sweep(harmonic_family(1, 3), GRID, n_samples=65536)
    return out


@pytest.fixture(scope="module")
def tour():
    spec = importlib.util.spec_from_file_location(
        "service_quickstart_torch", ROOT / "examples" / "service_quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        got = mod.main(device="cpu")
    return got, _reference_tour(), printed.getvalue()


def test_launch_counts_equal_the_reference_scripts(tour):
    got = tour[0]
    assert got["launches"] == LAUNCHES
    assert got["fallback_rounds"] == 0


@pytest.mark.parametrize("stage", ["a", "b", "c", "d", "e", "inf", "restart_cold",
                                   "restart_warm", "telemetry", "sweep", "sweep_finer",
                                   "sweep_again"])
def test_stage_matches_reference_engine(tour, stage):
    got, want = tour[0][stage], tour[1][stage]
    assert got.names == want.names
    assert got.stream_ids == want.stream_ids
    assert got.n_per_family == want.n_per_family
    assert got.served_from_cache == want.served_from_cache
    np.testing.assert_allclose(got.means, want.means, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.stderrs, want.stderrs, rtol=RTOL, atol=ATOL)
    if stage.startswith("sweep"):
        assert (got.grid_shape, got.axis_names, got.n_points) == (
            want.grid_shape, want.axis_names, want.n_points)


def test_telemetry_traced_every_wave_stage(tour):
    totals = tour[0]["span_totals"]
    assert {"plan", "launch", "device_execute", "transfer", "deposit"} <= set(totals)


def test_prints_the_reference_scripts_lines(tour):
    """The lines the reference script prints, in its order and format."""
    text = tour[2]
    want = [r"^cold: 2 launches for both clients \(B deduped onto A's cache entry: "
            r"from_cache=True\)$",
            r"^first three harmonic modes \(estimate \+- stderr vs analytic\):$",
            r"^  F_1   = \S+ \+- \S+   exact \S+$",
            r"^warm: 0 launches, identical result$",
            r"^top-up to 2x budget: 1 launch, stderr \S+ -> \S+$",
            r"^to-precision: max stderr \S+ after \d+ samples$",
            r"^infinite domain: gaussian over R\^3 in 1 fused launch, max error \S+ "
            r"\(stderr \S+\)$",
            r"^engine stats: EngineStats\(submitted=6, served=6, cache_hits=2, ",
            r"^restart: 0 launches, bit-identical result from persisted state$",
            r"^telemetry: stream [0-9a-f]{16}\.\.\. converged \S+ -> \S+ over \d+ rounds; "
            r"1 launches, 1 waves recorded$",
            r"^per-stage wall time: plan \S+ms, launch \S+ms, ",
            r"^sweep: 64 grid points over axes \('a', 'b'\) in 1 fused launch\(es\); "
            r"surface shape \(8, 8\)$",
            r"^sweep top-up: 1 launch\(es\) for the extra rounds, re-ask free; "
            r"max stderr \S+ -> \S+$"]
    at = 0
    for pattern in want:
        m = re.compile(pattern, re.M).search(text, at)
        assert m, (pattern, text)
        at = m.end()
