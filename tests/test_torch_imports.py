"""The port imports neither jax nor repro: every module of
src/repro_torch, the port's example scripts (examples/*_torch.py) and
chip_smoke.py, checked on their syntax trees (a text search would match
'repro' inside 'repro_torch')."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
         + sorted((ROOT / "examples").glob("*_torch.py")) + [ROOT / "chip_smoke.py"])


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                raise AssertionError(f"{path}: relative import")
            names.add(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax", "optax")


def test_files_found():
    assert len(FILES) > 15


@pytest.mark.parametrize("part", ["obs", "service", "analysis",
                                  "analysis/boundary.py", "analysis/contracts.py",
                                  "launch/check_analysis.py",
                                  "launch/serve_integrals.py",
                                  "core/adaptive.py", "core/stratified.py",
                                  "core/reduction.py", "core/tree_search.py",
                                  "core/normal.py", "kernels/moments",
                                  "models", "configs", "launch/serve.py",
                                  "launch/specs.py", "models/mla.py", "models/moe.py",
                                  "models/ssm.py", "optim", "optim/optimizers.py",
                                  "optim/schedule.py", "data", "data/pipeline.py",
                                  "distributed/checkpoint.py", "launch/train.py",
                                  "distributed/sharding.py", "distributed/fsdp.py",
                                  "distributed/elastic.py", "distributed/pipeline.py",
                                  "distributed/collectives.py", "launch/dryrun.py"])
def test_scan_covers_service_slice(part):
    """The service slice's subpackages, the adaptive and stratified
    slice's modules, the invariant checker's, the LM serving slices', the
    LM training slice's and the LM multi-device path's are among the
    scanned files."""
    root = ROOT / "src" / "repro_torch" / part
    assert any(p == root or root in p.parents for p in FILES), part


@pytest.mark.parametrize("name", ["quickstart", "harmonic_modes", "boltzmann_collision",
                                  "service_quickstart", "train_lm"])
def test_scan_covers_the_examples(name):
    assert ROOT / "examples" / f"{name}_torch.py" in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = sorted(n for n in _imported(path) if _forbidden(n))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_sees_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.core\nfrom repro.core import rng\n"
                 "def f():\n    import jax.numpy as jnp\n")
    assert sorted(n for n in _imported(p) if _forbidden(n)) == ["jax.numpy",
                                                                "repro.core"]
