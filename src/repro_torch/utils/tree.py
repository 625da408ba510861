"""Named walks over the port's trees: nested NamedTuples, dicts, lists and
tuples whose leaves are tensors or numpy arrays.

A leaf's name is its path joined by ``/``, as the JAX package's
``tree_map_with_path_names`` names it: a NamedTuple field by its name, a
dict entry by its key (keys in sorted order, as JAX flattens a dict), a
list or tuple entry by its index. ``{"state": SimState, "acc":
TelemetrySummary}`` gives ``state/t``, ``acc/energy_kwh`` and so on.
``None`` is an empty subtree, as in JAX: it has no leaf and stays
``None`` (the port's ``TelemetrySummary`` carries its switched-off blocks
so). A checkpoint's file layout is these names, so the two packages read
each other's checkpoints.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(x) -> List[Tuple[str, Any]] | None:
    """(name, child) pairs of a node, or None for a leaf."""
    if _is_namedtuple(x):
        return list(zip(x._fields, x))
    if isinstance(x, dict):
        return [(str(k), x[k]) for k in sorted(x)]
    if isinstance(x, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(x)]
    return None


def _join(prefix: str, name: str) -> str:
    return f"{prefix}/{name}" if prefix else name


def tree_leaves_with_names(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """Every leaf of ``tree`` with its name, in flattening order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out += tree_leaves_with_names(child, _join(prefix, name))
    return out


def tree_map_with_path_names(fn: Callable[[str, Any], Any], tree,
                             prefix: str = ""):
    """``tree`` rebuilt with each leaf replaced by ``fn(name, leaf)``;
    ``None`` stays ``None``."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(
            tree_map_with_path_names(fn, v, _join(prefix, f))
            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {k: tree_map_with_path_names(fn, tree[k], _join(prefix, str(k)))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map_with_path_names(fn, v, _join(prefix, str(i)))
            for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_map(fn: Callable[[Any], Any], tree):
    """``tree`` with each leaf replaced by ``fn(leaf)``."""
    return tree_map_with_path_names(lambda _, x: fn(x), tree)


__all__ = ["tree_leaves_with_names", "tree_map_with_path_names", "tree_map"]
