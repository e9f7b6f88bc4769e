"""Nests of dicts, lists and tuples with tensor leaves: the port's
counterpart of the ``jax.tree_util`` calls the train path makes.

Leaves are visited in insertion order of dicts and index order of lists;
a path is written as ``jax.tree_util.keystr`` writes one (``['layers'][0]
['mixer']['wq']``).  ``is_leaf`` stops the walk at a node of the caller's
choosing (the int8 moments' ``{"q", "scale"}`` pairs, the compressed
gradients' ``(q, scale)`` tuples).
"""
from __future__ import annotations

from typing import Any, Callable


def _children(node):
    if isinstance(node, dict):
        return [(f"[{k!r}]", v) for k, v in node.items()]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def leaves_with_paths(tree, is_leaf: Callable[[Any], bool] | None = None,
                      prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` of every leaf, in tree order."""
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += leaves_with_paths(child, is_leaf, prefix + key)
    return out


def leaves(tree, is_leaf: Callable[[Any], bool] | None = None) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree, is_leaf)]


def tree_map(fn: Callable, tree, *rest,
             is_leaf: Callable[[Any], bool] | None = None):
    """``fn`` over the leaves of ``tree`` and the matching nodes of
    ``rest`` (which share ``tree``'s structure down to its leaves)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(tree, flat: list, is_leaf: Callable[[Any], bool] | None
                   = None):
    """``tree``'s structure with its leaves replaced, in order, by
    ``flat``."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), tree, is_leaf=is_leaf)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


_END = object()
