"""The port's invariant checker (``repro_torch.analysis``) held against the
reference's (``repro.analysis``) on the same inputs.

* Layer 3, the stream auditor: on port-written state dirs (a live
  service's, abandoned mid-run and after a clean close; the STR001-STR007
  corruptions of ``tests/analysis/test_streams.py``, written through the
  port's store) and on the dir ``tests/analysis/fixtures/service/
  seed_broken_grid_chain.py`` seeds through the reference's store, both
  auditors report the same ``(rule, path, line, message)`` list, in the
  same order, and the same counts.
* Layer 1, the AST lint: each rule fires at its stated lines on fixtures
  written in the port's terms under ``tmp_path``, the ignore comment is
  scoped to its rule, and the real tree is clean.
* Layer 2, the form contracts: the counterparts of
  ``tests/analysis/test_contracts.py`` on the port's eval bodies, and the
  builtin forms' capability combinations equal the reference's.
* The CLIs: ``python -m repro_torch.analysis`` (exit codes, rule IDs, the
  lint alone importing neither torch, jax nor repro) and
  ``serve_integrals --audit-state``.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import boundary, contracts, streams
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.violations import RULES
from repro_torch.kernels import registry
from repro_torch.kernels.registry import KernelForm
from repro_torch.service.store import DurableStore, EntryState

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
RS = 64   # round quantum of the seeded state dirs, as the reference's tests


def _both(path):
    """(port report, reference report) of one state dir."""
    from repro.analysis.streams import audit_state_dir as ref_audit
    return streams.audit_state_dir(str(path)), ref_audit(str(path))


def _key(report):
    return [(v.rule, v.path, v.line, v.message) for v in report.violations]


def _assert_same(path):
    got, want = _both(path)
    assert _key(got) == _key(want)
    for field in ("streams", "journal_records", "deposits_folded",
                  "deposits_replayed", "truncated_tail_bytes"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.summary() == want.summary()
    return got


# -- Layer 3: seeded state dirs, written through the port's store ----------------

def _dep(store, chash, round_index, n_fn, n=RS):
    return store.deposit_record(chash, round_index, np.ones(n_fn, np.float32),
                                np.ones(n_fn, np.float32), n)


def _edges(n_bins=4):
    e = np.linspace(0.0, 1.0, n_bins + 1, dtype=np.float32)
    return np.broadcast_to(e, (1, 2, n_bins + 1)).copy()


def _overlap(s, _):
    s.append_alloc("aaa", fn_offset=0, n_fn=8, round_samples=RS)
    s.append_alloc("bbb", fn_offset=4, n_fn=8, round_samples=RS)


def _gap(s, _):
    s.append_alloc("aaa", fn_offset=0, n_fn=8, round_samples=RS)
    s.append_deposits([_dep(s, "aaa", 1, 8)])


def _shape(s, _):
    s.append_alloc("aaa", fn_offset=0, n_fn=8, round_samples=RS)
    s.append_deposits([_dep(s, "aaa", 0, n_fn=3)])


def _quantum_dep(s, _):
    s.append_alloc("aaa", fn_offset=0, n_fn=8, round_samples=RS)
    s.append_deposits([_dep(s, "aaa", 0, 8, n=RS + 1)])


def _hwm(s, _):
    s.snapshot([], next_id=100, round_samples=RS)
    s.append_alloc("aaa", fn_offset=10, n_fn=8, round_samples=RS)


def _meta_quantum(s, _):
    s.ensure_meta({"seed": 0, "round_samples": RS})
    s.append_alloc("aaa", fn_offset=0, n_fn=8, round_samples=RS * 2)


def _orphan(s, _):
    s.append_deposits([_dep(s, "ghost", 0, 8)])


def _chain_gap(s, _):
    s.append_alloc("base", fn_offset=0, n_fn=1, round_samples=RS)
    s.append_grid("ep1", parent="base", epoch=1, edges=_edges())
    s.append_alloc("ep1", fn_offset=1, n_fn=1, round_samples=RS)
    s.append_grid("ep3", parent="ep1", epoch=3, edges=_edges())
    s.append_alloc("ep3", fn_offset=2, n_fn=1, round_samples=RS)


def _grid_after_alloc(s, _):
    s.append_alloc("base", fn_offset=0, n_fn=1, round_samples=RS)
    s.append_alloc("ep1", fn_offset=1, n_fn=1, round_samples=RS)
    s.append_grid("ep1", parent="base", epoch=1, edges=_edges())


def _grid_disagrees(s, _):
    s.append_grid("ep1", parent="base", epoch=1, edges=_edges())
    s.append_grid("ep1", parent="other", epoch=1, edges=_edges())
    s.append_alloc("ep1", fn_offset=0, n_fn=1, round_samples=RS)


def _snapshot_hwm(s, _):
    s.snapshot([EntryState(chash="aaa", fn_offset=0, n_fn=16, round_samples=RS,
                           s1=np.zeros(16, np.float32), s2=np.zeros(16, np.float32))],
               next_id=8, round_samples=RS)


def _clean(s, _):
    s.ensure_meta({"seed": 0, "round_samples": RS})
    s.append_alloc("aaa", fn_offset=0, n_fn=8, round_samples=RS)
    s.append_alloc("bbb", fn_offset=8, n_fn=4, round_samples=RS)
    s.append_deposits([_dep(s, "aaa", 0, 8), _dep(s, "bbb", 0, 4), _dep(s, "aaa", 1, 8)])


def _replayed(s, _):
    s.append_alloc("aaa", fn_offset=0, n_fn=8, round_samples=RS)
    s.append_deposits([_dep(s, "aaa", 0, 8), _dep(s, "aaa", 0, 8), _dep(s, "aaa", 1, 8)])


def _torn(s, path):
    s.append_alloc("aaa", fn_offset=0, n_fn=8, round_samples=RS)
    s.close()
    with open(os.path.join(path, "journal.bin"), "ab") as f:
        f.write(b"ZMJ1\x99\x99torn-at-sigkill")


def _grid_chain(s, _):
    s.append_alloc("base", fn_offset=0, n_fn=1, round_samples=RS)
    s.append_grid("ep1", parent="base", epoch=1, edges=_edges())
    s.append_alloc("ep1", fn_offset=1, n_fn=1, round_samples=RS)
    s.append_grid("ep2", parent="ep1", epoch=2, edges=_edges())
    s.append_grid("ep2", parent="ep1", epoch=2, edges=_edges())
    s.append_alloc("ep2", fn_offset=2, n_fn=1, round_samples=RS)
    s.append_deposits([_dep(s, "ep2", 0, 1)])


def _snapshot_chain(s, _):
    s.snapshot([EntryState(chash="aaa", fn_offset=0, n_fn=8, round_samples=RS,
                           s1=np.ones(8, np.float32), s2=np.ones(8, np.float32),
                           n=2 * RS, rounds_done=2)], next_id=8, round_samples=RS)
    s.append_deposits([_dep(s, "aaa", 2, 8)])


SEEDED = {
    "overlap": (_overlap, ["STR001"]),
    "gap": (_gap, ["STR002"]),
    "shape": (_shape, ["STR003"]),
    "quantum_dep": (_quantum_dep, ["STR003"]),
    "hwm": (_hwm, ["STR004"]),
    "meta_quantum": (_meta_quantum, ["STR005"]),
    "orphan": (_orphan, ["STR006"]),
    "chain_gap": (_chain_gap, ["STR007"]),
    "grid_after_alloc": (_grid_after_alloc, ["STR007"]),
    "grid_disagrees": (_grid_disagrees, ["STR007"]),
    "snapshot_hwm": (_snapshot_hwm, ["STR004"]),
    "clean": (_clean, []),
    "replayed": (_replayed, []),
    "torn": (_torn, []),
    "grid_chain": (_grid_chain, []),
    "snapshot_chain": (_snapshot_chain, []),
}


@pytest.mark.parametrize("case", sorted(SEEDED))
def test_seeded_dirs_audit_alike(tmp_path, case):
    """Each seeded dir of repro's stream tests, written by the port's
    store: the rules the reference's test expects, and the same report
    from both auditors."""
    build, rules = SEEDED[case]
    path = str(tmp_path / "state")
    store = DurableStore(path, fsync=False)
    build(store, path)
    store.close()
    got = _assert_same(path)
    assert [v.rule for v in got.violations] == rules
    if case == "torn":
        assert got.truncated_tail_bytes > 0
        assert streams.audit_state_dir(path).truncated_tail_bytes == got.truncated_tail_bytes


def test_reference_seeded_broken_grid_chain(tmp_path):
    """The dir repro's CI seeds through its own store: two STR007 breaks,
    reported alike."""
    spec = importlib.util.spec_from_file_location(
        "seed_broken_grid_chain",
        ROOT / "tests/analysis/fixtures/service/seed_broken_grid_chain.py")
    seeder = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(seeder)
    seeder.seed(str(tmp_path / "state"))
    got = _assert_same(tmp_path / "state")
    assert [v.rule for v in got.violations] == ["STR007", "STR007"]


@pytest.fixture(scope="module")
def service_dirs(tmp_path_factory):
    """A live port service's state dir with the debug asserts on: four
    requests (one adaptive, so the journal carries grid records) abandoned
    after one wave (a copy kept), then resumed and closed."""
    import shutil

    from repro_torch.core import genz, integrand
    from repro_torch.service import IntegrationEngine
    from repro_torch.service.api import IntegrationRequest
    d = tmp_path_factory.mktemp("service")
    path = str(d / "state")
    kw = dict(round_samples=1024, device="cpu", state_dir=path, store_fsync=False,
              max_rounds_per_wave=2, adapt_pilot_samples=1024, adapt_rounds_per_epoch=1)
    reqs = [IntegrationRequest.make((integrand.harmonic_family(2, 2 + i % 2),),
                                    n_samples=4096) for i in range(3)]
    reqs.append(IntegrationRequest.make((genz.corner_peak(2, 2)[0],),
                                        target_stderr=3e-4, adaptive=True))
    streams.enable_asserts(True)
    try:
        engine = IntegrationEngine(**kw)
        for r in reqs:
            engine.submit(r)
        engine.step()
        shutil.copytree(path, d / "abandoned")
        del engine
        engine = IntegrationEngine(**kw)
        tickets = [engine.submit(r) for r in reqs]
        while engine.step():
            pass
        assert all(engine.poll(t) is not None for t in tickets)
        shutil.copytree(path, d / "served")
        engine.close()
    finally:
        streams.enable_asserts(None)
    return d


@pytest.mark.parametrize("which", ["abandoned", "served", "state"])
def test_service_dir_audits_clean_alike(service_dirs, which):
    """Abandoned (journal), served (longer journal) and closed (snapshot):
    clean to both auditors, with the same counts."""
    got = _assert_same(service_dirs / which)
    assert got.ok and got.streams >= 3
    if which != "state":
        records, _ = _journal(service_dirs / which)
        assert any(r["t"] == "grid" for r in records)


def _journal(path):
    from repro_torch.service.store import read_journal
    return read_journal(str(Path(path) / "journal.bin"))


def test_classify_round():
    assert streams.classify_round(3, 2) == "replay"
    assert streams.classify_round(3, 3) == "fold"
    assert streams.classify_round(3, 4) == "gap"


# -- Layer 1: the lint, on fixtures in the port's terms ---------------------------

FIXTURES = {
    "boundary_breach.py": ('''"""BND001: jax and the reference package."""
import jax
from repro.core import rng
import repro.analysis as ra
from repro_torch.core import rng as port_rng


def f():
    import jax.numpy as jnp
    return jax, rng, ra, port_rng, jnp
''', {"BND001": [2, 3, 4, 9]}),
    "launch/loader.py": ('''"""BND002: a library loaded and nvcc run outside kernels/build.py."""
import ctypes
import subprocess
from ctypes import CDLL


def load(path):
    lib = ctypes.CDLL(path)
    subprocess.run(["nvcc", "-c", "x.cu"], check=True)
    subprocess.run(["ls"], check=True)
    return lib, CDLL
''', {"BND002": [4, 8, 9]}),
    "kernels/impure_eval.py": ('''"""PUR001: clock, stateful RNG, host I/O."""
import time
import random

import numpy as np
import torch


def eval_body(draw, p, dim):
    jitter = np.random.uniform() + float(torch.rand(1))
    with open("eval.log", "a") as fh:
        fh.write(f"{time.time()} {random.random()}")
    return draw(0) + jitter
''', {"PUR001": [2, 3, 10, 10, 11]}),
    "kernels/f64_accum.py": ('''"""F64001: float64 on an accumulator path."""
import numpy as np
import torch


def eval_body(draw, p, dim):
    acc = torch.zeros((16, 2048), dtype=torch.float64)
    val = draw(0).double() + np.float64(1.0)
    ref = np.zeros(3, dtype="float64")
    return (acc + val).to(torch.double) + ref.astype("float64").sum()
''', {"F64001": [7, 8, 9, 10, 10]}),
    "service/wallclock_use.py": ('''"""OBS001: the wall clock read around the shim."""
import time

from repro_torch.obs import clock


def wave_timer():
    t0 = time.monotonic()
    ok = clock.monotonic()
    return time.perf_counter() - t0, ok
''', {"OBS001": [2, 8, 10]}),
    "service/adhoc_retry.py": ('''"""RES001: an ad-hoc retry loop in the service."""
from repro_torch.distributed.fault_tolerance import run_with_restarts

from repro_torch.distributed import fault_tolerance as ft
from repro_torch.obs import clock


def flaky_wave(body):
    ft.run_with_restarts(body, max_restarts=3)
    clock.sleep(0.25)
    return run_with_restarts
''', {"RES001": [2, 9, 10]}),
    "ignored_ok.py": ('''"""Every would-be violation carries its ignore comment."""
import jax  # analysis: ignore[BND001]
import ctypes

LIB = ctypes.CDLL("x.so")  # analysis: ignore[BND002]
''', {}),
}


def _write_fixtures(root):
    for rel, (source, _) in FIXTURES.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(source)


@pytest.mark.parametrize("rel", sorted(FIXTURES))
def test_lint_fixture_fires_at_its_lines(tmp_path, rel):
    _write_fixtures(tmp_path)
    found = boundary.check_file(tmp_path / rel)
    by_rule = {}
    for v in found:
        by_rule.setdefault(v.rule, []).append(v.line)
    assert {k: sorted(v) for k, v in by_rule.items()} == FIXTURES[rel][1], found
    assert all(v.path.endswith(rel) for v in found)


def test_fixture_dir_scan_finds_every_lint_rule(tmp_path):
    _write_fixtures(tmp_path)
    assert {v.rule for v in boundary.check_paths([tmp_path])} == {
        "BND001", "BND002", "PUR001", "F64001", "OBS001", "RES001"}


def test_ignore_comment_is_rule_specific():
    source = "import jax  # analysis: ignore[BND002]\n"
    assert [v.rule for v in boundary.check_source(source, "repro_torch/x.py")] == ["BND001"]


@pytest.mark.parametrize("path,rules", [
    ("repro_torch/kernels/build.py", []),
    ("repro_torch/kernels/template.py", ["PUR001", "BND002", "BND002"]),
    ("repro_torch/launch/kernel_ab.py", ["BND002", "BND002"]),
])
def test_only_the_build_module_builds_and_loads(path, rules):
    """kernels/build.py imports time, runs nvcc and loads libraries; the
    same lines anywhere else fire (PUR001 only in the pure scope)."""
    source = ("import time\nimport ctypes\nimport subprocess\n"
              "subprocess.Popen([nvcc, '-c', 'a.cu'])\nctypes.CDLL('lib.so')\n")
    assert [v.rule for v in boundary.check_source(source, path)] == rules


@pytest.mark.parametrize("path,rules", [
    ("repro_torch/launch/runner.py", []),
    ("repro_torch/distributed/ft.py", []),
    ("repro_torch/kernels/body.py", ["PUR001"]),
    ("repro_torch/core/refs.py", ["PUR001"]),
    ("repro_torch/service/engine.py", ["OBS001", "OBS001"]),
    ("repro_torch/obs/trace.py", ["OBS001", "OBS001"]),
    ("repro_torch/obs/clock.py", []),
])
def test_clock_rules_scope(path, rules):
    source = "import time\nt = time.monotonic()\n"
    assert [v.rule for v in boundary.check_source(source, path)] == rules


@pytest.mark.parametrize("path,rules", [
    ("repro_torch/distributed/ft.py", []),
    ("repro_torch/launch/runner.py", []),
    ("repro_torch/obs/export.py", []),
    ("repro_torch/service/engine.py", ["RES001", "RES001"]),
    ("repro_torch/service/resilience.py", []),
])
def test_retry_rule_scope(path, rules):
    source = ("from repro_torch.distributed.fault_tolerance import "
              "run_with_restarts\nclock.sleep(1.0)\n")
    assert [v.rule for v in boundary.check_source(source, path)] == rules


def test_host_float64_and_dtype_casts_are_not_flagged():
    source = ("import numpy as np\nimport torch\nx = np.float64(1.0)\n"
              "y = np.asarray([1.0], np.float64)\nz = torch.zeros(2).to(torch.float32)\n")
    assert boundary.check_source(source, "repro_torch/core/refs.py") == []


@pytest.mark.parametrize("subtree", [
    "kernels", "core", "service", "obs", "launch", "analysis", "distributed"])
def test_real_tree_is_clean(subtree):
    assert boundary.check_paths([PORT / subtree]) == []


# -- the CLIs -------------------------------------------------------------------

def test_cli_real_tree_and_contracts_exit_zero():
    assert main([]) == 0


def test_cli_seeded_fixtures_exit_one_with_rule_and_location(tmp_path, capsys):
    _write_fixtures(tmp_path)
    assert main([str(tmp_path)]) == 1
    out = capsys.readouterr().out
    for rel, (_, rules) in FIXTURES.items():
        for rule, lines in rules.items():
            assert f"{rule} {tmp_path / rel}:{lines[0]} " in out
    for rel, (_, rules) in FIXTURES.items():
        assert main([str(tmp_path / rel)]) == (1 if rules else 0), rel


def test_cli_list_rules_matches_the_reference(capsys):
    from repro.analysis.__main__ import main as ref_main
    assert main(["--list-rules"]) == 0
    ours = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert ref_main(["--list-rules"]) == 0
    theirs = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert ours == theirs == sorted(RULES)


def test_cli_state_dirs_and_the_launcher_alias(tmp_path, capsys):
    from repro_torch.launch import check_analysis
    assert check_analysis.main is main
    for case in ("clean", "gap"):
        store = DurableStore(str(tmp_path / case), fsync=False)
        SEEDED[case][0](store, str(tmp_path / case))
        store.close()
    one = str(PORT / "device.py")
    assert main([one, "--state-dir", str(tmp_path / "clean")]) == 0
    capsys.readouterr()
    assert main([one, "--state-dir", str(tmp_path / "clean"),
                 "--state-dir", str(tmp_path / "gap")]) == 1
    out = capsys.readouterr().out
    assert "STR002" in out and "journal.bin:2" in out


def test_skip_contracts_imports_neither_torch_nor_jax_nor_repro():
    code = ("import sys\nfrom repro_torch.analysis.__main__ import main\n"
            "rc = main(['--skip-contracts'])\n"
            "print(rc, sorted(m for m in sys.modules\n"
            "      if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120, check=True)
    assert proc.stdout.split("\n")[-2] == "0 []", proc.stdout + proc.stderr


def test_serve_integrals_audit_state_exit_codes(tmp_path, capsys):
    """repro's test_state_dir_audit_exit_codes, through the port's
    launcher: 0 clean, 1 with the violation's rule and location, 2
    without --state-dir."""
    from repro_torch.launch import serve_integrals
    for case in ("clean", "gap"):
        store = DurableStore(str(tmp_path / case), fsync=False)
        SEEDED[case][0](store, str(tmp_path / case))
        store.close()
    for case, code in (("clean", 0), ("gap", 1)):
        with pytest.raises(SystemExit) as exc:
            serve_integrals.main(["--audit-state", "--state-dir", str(tmp_path / case)])
        assert exc.value.code == code
    out = capsys.readouterr().out
    assert "STR002" in out and "journal.bin:2" in out and "clean" in out
    with pytest.raises(SystemExit) as exc:
        serve_integrals.main(["--audit-state"])
    assert exc.value.code == 2


# -- Layer 2: the form contracts ----------------------------------------------------

def _good_body(draw, p, dim):
    val = p[:, 0:1] * draw(0)
    for d in range(1, dim):
        val = val * draw(d)
    return val


def _good_body_2(draw, p, dim):
    val = p[:, 0:1] + draw(0)
    for d in range(1, dim):
        val = val + draw(d)
    return val


def _int32_body(draw, p, dim):
    return (draw(0) * 0).to(torch.int32)


def _scalar_body(draw, p, dim):
    return torch.sum(draw(0))


def _item_body(draw, p, dim):
    return draw(0) * p[:, 0:1].max().item()


def _finite_only_body(draw, p, dim):
    # runs on the finite packing, fails on the wrappers' wider block
    assert p.shape[1] == 1, "finite packing only"
    return draw(0) * p[:, 0:1]


IMPURE = {
    "item": _item_body,
    "bool": lambda draw, p, dim: draw(0) if bool((draw(0) > 0).any()) else -draw(0),
    "tolist": lambda draw, p, dim: draw(0) + len(draw(0).tolist()),
    "numpy": lambda draw, p, dim: draw(0) + float(draw(0).numpy().sum()),
    "cpu": lambda draw, p, dim: draw(0).cpu(),
    "to_device": lambda draw, p, dim: draw(0).to("cpu"),
    "random": lambda draw, p, dim: draw(0) * torch.rand_like(draw(0)),
    "nonzero": lambda draw, p, dim: draw(0) + torch.nonzero(draw(0)).shape[0],
}


def _form(body, name="fixture_form", form_id=7, **kw):
    kw.setdefault("samplers", ("mc",))
    kw.setdefault("supports_compactified", False)
    kw.setdefault("supports_adapted", False)
    return KernelForm(name=name, form_id=form_id, body=body,
                      pack_params=lambda fam: None, n_cols=lambda dim: 1, **kw)


def _rules(violations):
    return {v.rule for v in violations}


def test_good_body_is_clean():
    assert contracts.check_form(_form(_good_body)) == []


def test_int32_accumulator_fires_kct002():
    found = contracts.check_form(_form(_int32_body))
    assert _rules(found) == {"KCT002"}
    assert all(v.path.endswith("test_torch_analysis.py") and v.line > 0 for v in found)


def test_scalar_output_fires_shape_contract():
    found = contracts.check_form(_form(_scalar_body))
    assert "KCT002" in _rules(found)
    assert any("shaped" in v.message for v in found)


@pytest.mark.parametrize("kind", sorted(IMPURE))
def test_impure_body_fires_kct001(kind):
    """Host syncs, copies off the device and random ops."""
    found = contracts.check_form(_form(IMPURE[kind]))
    assert _rules(found) == {"KCT001"}, found
    assert len(found) == len(contracts.PROBE_DIMS)


def test_broken_compactified_support_fires_kct004():
    assert "KCT004" in _rules(contracts.check_form(
        _form(_finite_only_body, supports_compactified=True)))
    assert contracts.check_form(_form(_finite_only_body)) == []


def test_broken_adapted_support_fires_kct006():
    found = contracts.check_form(_form(_finite_only_body, supports_adapted=True))
    assert "KCT006" in _rules(found)
    assert any("adapted" in v.message for v in found)
    assert contracts.check_form(_form(_good_body, supports_adapted=True)) == []


def test_mismatched_bucket_outputs_fire_kct003():
    forms = [_form(_good_body, "good_a"), _form(_good_body_2, "good_b"),
             _form(_int32_body, "bad_int32")]
    found = contracts.check_bucket_uniformity(forms)
    assert found and _rules(found) == {"KCT003"}
    assert all("bad_int32" in v.message for v in found)
    assert contracts.check_bucket_uniformity(forms[:2]) == []


def test_contract_breaking_form_raises_at_registration():
    with pytest.raises(ValueError, match="(?s)fixture_bad_int32.*KCT002"):
        registry.register_form(_form(_int32_body, "fixture_bad_int32"))
    assert "fixture_bad_int32" not in registry.names()
    assert registry.form("fixture_bad_int32") is None


def test_bucket_mismatch_raises_naming_form_and_bucket():
    with pytest.raises(ValueError) as exc:
        contracts.validate_form_registration(
            _form(_good_body, "fixture_newcomer"), [_form(_int32_body, "old_int32")])
    msg = str(exc.value)
    assert "fixture_newcomer" in msg and "dim=" in msg and "sampler=" in msg
    assert "KCT003" in msg


@pytest.fixture
def free_form_id(monkeypatch):
    """A form id freed for the test (every id of the kernel's switch is a
    builtin's), and the test's registrations dropped after it."""
    registry.forms()
    monkeypatch.delitem(registry._BY_ID, 4)
    forms, impls = dict(registry._FORMS), dict(registry._REGISTRY)
    yield 4
    for table, saved in ((registry._FORMS, forms), (registry._REGISTRY, impls)):
        for name in set(table) - set(saved):
            del table[name]
    registry._BY_ID.pop(4, None)


def test_validate_false_bypasses_the_gate(free_form_id):
    registry.register_form(_form(_int32_body, "fixture_unvalidated", form_id=free_form_id),
                           validate=False)
    assert "fixture_unvalidated" in registry.names()


def test_good_form_registers_cleanly_against_builtins(free_form_id):
    registry.register_form(_form(_good_body, "fixture_good_form", form_id=free_form_id,
                                 samplers=("mc", "sobol"), supports_compactified=True,
                                 supports_adapted=True))
    assert {"fixture_good_form", "fixture_good_form@sobol"} <= set(registry.names())


def test_real_registry_is_clean():
    assert contracts.check_registered_forms() == []
    assert contracts.check_bucket_uniformity(registry.forms()) == []


@pytest.mark.parametrize("name", ["mc_eval_harmonic", "mc_eval_abs_sum", "mc_eval_gaussian",
                                  "mc_eval_genz_osc", "mc_eval_genz_corner"])
def test_builtin_combos_equal_the_reference(name):
    """Each builtin form advertises the combinations repro's form of the
    same name does, so both checkers probe the same set."""
    from repro.analysis import contracts as ref_contracts
    from repro.kernels import registry as ref_registry
    assert contracts._combos(registry.form(name)) == ref_contracts._combos(
        ref_registry.form(name))
    assert contracts.PROBE_DIMS == ref_contracts.PROBE_DIMS
    assert contracts.PROBE_BINS == ref_contracts.PROBE_BINS


def test_probe_operands_shape_the_plain_kernels_block():
    from repro_torch.kernels import template
    draws, packed = template.probe_operands(3, 5)
    assert draws.shape == (3, template.F_BLK, template.S_BLK)
    assert packed.shape == (template.F_BLK, 5)
    assert draws.dtype == packed.dtype == torch.float32
