"""Every name that a module of repro exports in ``__all__`` is exposed by
its counterpart in repro_torch (the same dotted path under the port's
package).  The reference's ``__all__`` is read from its syntax tree, so the
check imports no jax."""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"


def _exported(path: Path) -> list[str]:
    for node in ast.parse(path.read_text(), str(path)).body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets)):
            return list(ast.literal_eval(node.value))
    return []


MODULES = sorted(p for p in REF.rglob("*.py") if _exported(p))


def _port_name(path: Path) -> str:
    parts = path.relative_to(REF).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(("repro_torch",) + parts)


def test_modules_found():
    names = {_port_name(p) for p in MODULES}
    assert {"repro_torch.core", "repro_torch.service", "repro_torch.obs"} <= names


@pytest.mark.parametrize("path", MODULES, ids=_port_name)
def test_port_exposes_every_exported_name(path):
    module = importlib.import_module(_port_name(path))
    missing = [n for n in _exported(path) if not hasattr(module, n)]
    assert not missing, f"{module.__name__} lacks {missing}"
    if hasattr(module, "__all__"):
        assert not set(_exported(path)) - set(module.__all__)
