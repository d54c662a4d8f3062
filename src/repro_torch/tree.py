"""Pytree helpers for the port's nested containers, in JAX's flatten order:
dict values by sorted key, NamedTuple / tuple / list items in order, None
an empty subtree; any other object (a tensor, an array, a number) is a leaf.  Checkpoints and the
optimizer walk trees in this order, so their leaves line up with the
reference's."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["flatten", "unflatten", "leaves", "tree_map"]


def _children(node: Any):
    if node is None:                      # an empty subtree, as in JAX
        return [], (type(None), None)
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return [node[k] for k in keys], (dict, keys)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(node), (type(node), None)
    if isinstance(node, (tuple, list)):
        return list(node), (type(node), None)
    return None, None


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; :func:`unflatten` inverts it."""
    out: List[Any] = []

    def walk(node):
        kids, kind = _children(node)
        if kids is None:
            out.append(node)
            return None
        return kind, [walk(c) for c in kids]

    return out, walk(tree)


def unflatten(treedef: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        (typ, keys), children = d
        vals = [build(c) for c in children]
        if typ is dict:
            return dict(zip(keys, vals))
        if typ is type(None):
            return None
        if hasattr(typ, "_fields"):
            return typ(*vals)
        return typ(vals)

    tree = build(treedef)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has places for")
    return tree


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure)."""
    flat, treedef = flatten(tree)
    others = [leaves(r) for r in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])
