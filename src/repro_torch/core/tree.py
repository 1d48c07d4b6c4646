"""Nested parameter dicts: the port's stand-in for JAX pytrees.

A family's ``params`` is a dict whose values are tensors or nested dicts
(a compactified family holds ``{"inner": user params, "aux": {"kind",
"shift"}}``).  Leaves are visited in sorted-key order, the order
``jax.tree_util`` flattens dicts in, so the service hashes the same
bytes as ``repro`` (``repro_torch.service.canonical``).
"""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable[[Any], Any], tree):
    """``tree`` with ``fn`` applied to every leaf (dicts rebuilt)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def treedef_str(tree) -> str:
    """The structure of ``tree`` as ``str(jax.tree_util.tree_structure)``
    prints a tree of dicts, e.g. ``PyTreeDef({'a': *, 'b': *})``."""
    def walk(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({walk(tree)})"
