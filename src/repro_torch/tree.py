"""Nested parameter trees of the port: dicts (keys in sorted order, as JAX
flattens them) and lists, with tensors at the leaves.

``leaves`` and ``tree_map`` visit the leaves in one fixed order, so a
list of leaves and its tree correspond entry for entry, as a JAX treedef
and its leaves do; ``paths`` names each leaf (``layers/0/attn/wq``).
"""

from __future__ import annotations

from typing import Any, Callable


def _children(node):
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def leaves(tree) -> list:
    """The tree's leaves in order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for _, v in kids for leaf in leaves(v)]


def paths(tree, prefix: str = "") -> list[str]:
    """Each leaf's path of keys and indices joined by ``/``."""
    kids = _children(tree)
    if kids is None:
        return [prefix]
    return [p for k, v in kids
            for p in paths(v, f"{prefix}/{k}" if prefix else k)]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), as a tree of that
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, flat: list) -> Any:
    """A tree of ``like``'s structure whose leaves are ``flat`` in
    ``leaves`` order."""
    if len(flat) != len(leaves(like)):
        raise ValueError(f"{len(flat)} leaves for a tree of "
                         f"{len(leaves(like))}")
    it = iter(flat)
    return _fill(like, it)


def _fill(like, it):
    if isinstance(like, dict):
        return {k: _fill(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, it) for v in like)
    return next(it)
