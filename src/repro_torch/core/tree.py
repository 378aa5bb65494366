"""Nested parameter trees: dicts (in sorted key order, as JAX flattens
them), lists and tuples of tensors."""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    """The leaves in flatten order; None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, in the structure of ``tree``, called in ``leaves`` order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)
