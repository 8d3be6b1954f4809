"""Minimal pytrees in JAX's leaf order.

Parameter trees in the port are nested dicts (and lists/tuples) of
tensors, as in the reference.  ``jax.tree.flatten`` visits dict entries in
**sorted key order**, while ``torch.utils._pytree`` keeps insertion order;
the packed delta layout (``repro_torch.fl.packing``), its padded widths
and byte counts, and the order of the L2 sum in the loss all follow the
leaf order, so the port flattens the JAX way.  ``None`` is an empty
subtree, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map"]

PyTree = Any
# treedef: "*" for a leaf, None for None, else (kind, keys, children)
TreeDef = Any
_END = object()


def tree_flatten(tree: PyTree) -> Tuple[List[Any], TreeDef]:
    """``(leaves, treedef)``; dict keys visited in sorted order.  The
    treedef is a hashable nested tuple."""
    leaves: List[Any] = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return ("dict", keys, tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return (kind, len(node), tuple(walk(c) for c in node))
        leaves.append(node)
        return "*"

    treedef = walk(tree)
    return leaves, treedef


def tree_unflatten(treedef: TreeDef, leaves) -> PyTree:
    """Inverse of ``tree_flatten``."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d == "*":
            return next(it)
        kind, keys, children = d
        if kind == "dict":
            return {k: build(c) for k, c in zip(keys, children)}
        out = [build(c) for c in children]
        return out if kind == "list" else tuple(out)

    out = build(treedef)
    if next(it, _END) is not _END:
        raise ValueError("tree_unflatten: more leaves than the treedef has")
    return out


def tree_leaves(tree: PyTree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over corresponding leaves of ``tree`` and ``rest`` (which
    must share its structure)."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError("tree_map: trees have different structures")
        others.append(r_leaves)
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])
