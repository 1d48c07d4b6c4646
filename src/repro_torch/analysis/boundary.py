"""Layer 1: the port's AST lint over its own tree (port of
``repro.analysis.boundary``).

Six rules, each enforcing an invariant the ROADMAP used to state only in
prose.  The IDs are the reference's; BND001 and BND002 there guard jax's
version drift (its two compat shims), which the port does not have, so
here they guard the port's own two boundaries:

* **BND001** — no ``import jax`` and no import of the reference package
  ``repro`` anywhere in ``repro_torch``: the port keeps its own copy of
  what it needs, even of a ``repro`` module that imports no jax.
* **BND002** — a built kernel library is loaded (``ctypes.CDLL``,
  ``ctypes.cdll``, ``torch.ops.load_library``) and ``nvcc`` is run (a
  ``subprocess``/``os.system`` call naming it, or
  ``torch.utils.cpp_extension``) only from ``repro_torch/kernels/build.py``,
  so every kernel is built and bound in one place, with its
  ``argtypes``/``restype`` declared.
* **PUR001** — modules under ``kernels/`` and ``core/`` hold eval bodies
  and counter plumbing whose outputs must be a pure function of (key,
  counters, params): no wall-clock (``time``), stateful RNG (``random``,
  ``np.random``, ``torch.rand``/``torch.manual_seed`` and kin),
  ``datetime``, or host I/O (``open``/``input``).  ``kernels/build.py``
  is the host-side kernel build, not an eval body, and is exempt
  (:data:`PURITY_ALLOWED`).
* **F64001** — no ``torch.float64``/``torch.double``/``.double()`` (or
  ``astype``/``dtype='float64'``) in ``kernels/`` / ``core/``:
  accumulators are f32 by contract (the WAL journals exact f32 bits).
  Host-side ``np.float64`` (analytic references, grid fitting) is fine
  and not flagged, as in the reference.
* **OBS001** — modules under ``service/`` and ``obs/`` read the wall
  clock only through ``obs/clock.py`` (no direct ``time`` import or
  ``time.*`` call).
* **RES001** — modules under ``service/`` retry, back off and sleep only
  through ``service/resilience.py``: importing the ad-hoc
  ``run_with_restarts`` loop or calling any ``.sleep(...)`` elsewhere in
  the service is flagged.

Escape hatch: append ``# analysis: ignore[RULE]`` (comma-separate for
several rules) to the offending line; it silences only the rules it
names.

The linter is pure ``ast`` + stdlib: it never imports the files it
checks (and never imports torch), so fixture files seeded with
violations are safe to scan.
"""

from __future__ import annotations

import ast
import os
import re
from pathlib import Path

from repro_torch.analysis.violations import Violation

# The one file allowed to load built libraries and run nvcc (BND002).
BUILD_ALLOWED = ("repro_torch/kernels/build.py",)

# Host-side files inside a purity scope that are not eval bodies or
# counter plumbing (PUR001): the kernel build times and runs nvcc.
PURITY_ALLOWED = ("repro_torch/kernels/build.py",)

# Top-level packages the port must never import (BND001).
_FOREIGN_PACKAGES = ("jax", "jaxlib", "repro")

# Path fragments marking purity-scoped modules (PUR001/F64001).  A
# segment match (not a suffix match) so fixtures laid out under
# ``kernels/`` / ``core/`` are scoped identically.
PURE_SCOPE_SEGMENTS = ("kernels", "core")

# Modules whose import into a pure scope is a PUR001 violation.
_IMPURE_MODULES = ("time", "random", "datetime")

# torch's stateful RNG entry points (PUR001 in a pure scope).
_TORCH_RNG = ("torch.rand", "torch.randn", "torch.randint", "torch.randperm",
              "torch.rand_like", "torch.randn_like", "torch.randint_like",
              "torch.normal", "torch.bernoulli", "torch.multinomial",
              "torch.manual_seed", "torch.seed", "torch.Generator",
              "torch.random")

# float64 spellings on a torch accumulator path (F64001).
_TORCH_F64 = ("torch.float64", "torch.double")

# Library loaders (BND002), as attribute chains and as ``from`` imports.
_LOADER_CHAINS = ("ctypes.CDLL", "ctypes.cdll", "torch.ops.load_library",
                  "torch.utils.cpp_extension")
_LOADER_NAMES = {"ctypes": ("CDLL", "cdll"),
                 "torch.utils": ("cpp_extension",)}
# Calls that start a process (BND002 when they name nvcc).
_PROCESS_CALLS = ("subprocess.", "os.system", "os.popen", "os.exec")

# Path fragments marking clock-shim-scoped modules (OBS001), and the
# one file allowed to touch ``time`` inside them.
OBS_SCOPE_SEGMENTS = ("service", "obs")
CLOCK_SHIM_SUFFIX = "obs/clock.py"

# Path fragments marking retry-policy-scoped modules (RES001), and the
# one file allowed to run retry loops and sleep inside them.
RES_SCOPE_SEGMENTS = ("service",)
RESILIENCE_SUFFIX = "service/resilience.py"

# The ad-hoc retry entry point RES001 bans outside the policy module.
_ADHOC_RETRY = "run_with_restarts"

# Builtin calls that do host I/O.
_IO_CALLS = ("open", "input")

_IGNORE_RE = re.compile(r"#\s*analysis:\s*ignore\[([A-Za-z0-9_,\s]+)\]")


def _posix(path) -> str:
    return str(path).replace(os.sep, "/")


def _in_scope(path: str, segments: tuple[str, ...]) -> bool:
    parts = path.split("/")
    return any(seg in parts[:-1] for seg in segments)


def _dotted(node: ast.AST) -> str | None:
    """'a.b.c' for an Attribute/Name chain, None for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _under(chain: str, prefixes: tuple[str, ...]) -> bool:
    """``chain`` is one of ``prefixes`` or an attribute of one."""
    return any(chain == p or chain.startswith(p + ".") for p in prefixes)


def _names_nvcc(node: ast.AST) -> bool:
    """Whether a call's argument subtree names nvcc (a string constant
    or a variable called so)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                and "nvcc" in sub.value:
            return True
        if isinstance(sub, ast.Name) and "nvcc" in sub.id:
            return True
    return False


def _ignored_rules(lines: list[str], lineno: int) -> set[str]:
    if not 1 <= lineno <= len(lines):
        return set()
    m = _IGNORE_RE.search(lines[lineno - 1])
    if not m:
        return set()
    return {r.strip() for r in m.group(1).split(",") if r.strip()}


class _Checker(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.build_module = any(path.endswith(s) for s in BUILD_ALLOWED)
        self.pure = (_in_scope(path, PURE_SCOPE_SEGMENTS)
                     and not any(path.endswith(s) for s in PURITY_ALLOWED))
        self.obs_scope = (_in_scope(path, OBS_SCOPE_SEGMENTS)
                          and not path.endswith(CLOCK_SHIM_SUFFIX))
        self.res_scope = (_in_scope(path, RES_SCOPE_SEGMENTS)
                          and not path.endswith(RESILIENCE_SUFFIX))
        self.found: list[Violation] = []

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        self.found.append(Violation(rule=rule, path=self.path,
                                    line=node.lineno, message=message))

    # -- imports --------------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self._check_module(node, alias.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        self._check_module(node, mod)
        if not self.build_module:
            for alias in node.names:
                if alias.name in _LOADER_NAMES.get(mod, ()):
                    self._flag("BND002", node,
                               f"import of {mod}.{alias.name} outside "
                               "kernels/build.py (load built libraries "
                               "through repro_torch.kernels.build)")
        if self.res_scope:
            for alias in node.names:
                if alias.name == _ADHOC_RETRY:
                    self._flag("RES001", node,
                               f"import of {_ADHOC_RETRY!r} in a service "
                               "module: retries go through "
                               "repro_torch.service.resilience.run_with_policy "
                               "(one policy, deterministic jitter, "
                               "deadline-aware)")
        self.generic_visit(node)

    def _check_module(self, node: ast.AST, mod: str) -> None:
        if mod.split(".")[0] in _FOREIGN_PACKAGES:
            self._flag("BND001", node,
                       f"import of {mod!r}: the port imports neither jax "
                       "nor the reference package (keep a copy in "
                       "repro_torch)")
        if self.pure and _under(mod, _IMPURE_MODULES):
            self._flag("PUR001", node,
                       f"import of {mod!r} in a purity-scoped module "
                       "(eval outputs must be a pure function of "
                       "key/counters/params)")
        if self.obs_scope and _under(mod, ("time",)):
            self._flag("OBS001", node,
                       f"import of {mod!r} in a service/obs module: go "
                       "through repro_torch.obs.clock (the single "
                       "wall-clock shim) so trace timestamps and "
                       "fake-clock tests stay consistent")

    # -- attribute chains -----------------------------------------------------
    def visit_Attribute(self, node: ast.Attribute) -> None:
        chain = _dotted(node)
        if chain is None:
            self.generic_visit(node)
            return
        if not self.build_module and _under(chain, _LOADER_CHAINS):
            self._flag("BND002", node,
                       f"reference to {chain!r} outside kernels/build.py "
                       "(load built libraries through "
                       "repro_torch.kernels.build)")
        if self.pure:
            if _under(chain, ("np.random", "numpy.random", *_TORCH_RNG)):
                self._flag("PUR001", node,
                           f"stateful RNG {chain!r} in a purity-scoped "
                           "module (use counter-based repro_torch.core.rng)")
            if chain in _TORCH_F64:
                self._flag("F64001", node,
                           "float64 on an accumulator path (deposits are "
                           "exact f32)")
        if self.obs_scope and chain.startswith("time."):
            self._flag("OBS001", node,
                       f"wall-clock read {chain!r} in a service/obs "
                       "module: use repro_torch.obs.clock")
        if self.res_scope and chain.endswith("." + _ADHOC_RETRY):
            self._flag("RES001", node,
                       f"reference to {chain!r} in a service module: "
                       "retries go through "
                       "repro_torch.service.resilience.run_with_policy")
        # a complete chain is all Names/Attributes: recursing would
        # re-flag its sub-chains on the same line

    # -- calls ----------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        func = _dotted(node.func) or ""
        if (not self.build_module and func.startswith(_PROCESS_CALLS)
                and any(_names_nvcc(a) for a in
                        [*node.args, *(k.value for k in node.keywords)])):
            self._flag("BND002", node,
                       f"{func}() runs nvcc outside kernels/build.py (build "
                       "through repro_torch.kernels.build)")
        if (self.res_scope and isinstance(node.func, ast.Attribute)
                and node.func.attr == "sleep"):
            self._flag("RES001", node,
                       "ad-hoc sleep in a service module: backoff pauses "
                       "belong to repro_torch.service.resilience (jittered, "
                       "clamped to the request deadline)")
        if self.pure:
            if isinstance(node.func, ast.Name) and node.func.id in _IO_CALLS:
                self._flag("PUR001", node,
                           f"host I/O call {node.func.id}() in a "
                           "purity-scoped module")
            if isinstance(node.func, ast.Attribute):
                if node.func.attr == "double" and not node.args:
                    self._flag("F64001", node,
                               ".double() on an accumulator path")
                if (node.func.attr in ("astype", "to")
                        and any(_is_f64_const(a) for a in node.args)):
                    self._flag("F64001", node,
                               f"{node.func.attr}('float64') on an "
                               "accumulator path")
            for kw in node.keywords:
                if kw.arg == "dtype" and _is_f64_const(kw.value):
                    self._flag("F64001", node,
                               "dtype='float64' on an accumulator path")
        self.generic_visit(node)


def _is_f64_const(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value in ("float64",
                                                            "double")


def check_source(source: str, path: str) -> list[Violation]:
    """Lint one file's source; ``path`` scopes the rules (see module
    docstring) and labels the violations."""
    path = _posix(path)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Violation(rule="BND001", path=path, line=exc.lineno or 0,
                          message=f"unparseable file: {exc.msg}")]
    checker = _Checker(path)
    checker.visit(tree)
    lines = source.splitlines()
    return [v for v in checker.found
            if v.rule not in _ignored_rules(lines, v.line)]


def check_file(path) -> list[Violation]:
    with open(path, encoding="utf-8") as f:
        return check_source(f.read(), _posix(path))


def iter_python_files(root):
    root = Path(root)
    if root.is_file():
        yield root
        return
    for path in sorted(root.rglob("*.py")):
        if any(part.startswith(".") for part in path.parts):
            continue
        yield path


def check_paths(paths) -> list[Violation]:
    """Lint every ``*.py`` under each path (files or directories)."""
    found: list[Violation] = []
    for root in paths:
        for path in iter_python_files(root):
            found.extend(check_file(path))
    return found
