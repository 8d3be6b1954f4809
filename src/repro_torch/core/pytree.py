"""Minimal pytrees in JAX's leaf order.

Parameter trees in the port are nested dicts (and lists/tuples) of
tensors, as in the reference.  ``jax.tree.flatten`` visits dict entries in
**sorted key order**, while ``torch.utils._pytree`` keeps insertion order;
the packed delta layout (``repro_torch.fl.packing``), its padded widths
and byte counts, and the order of the L2 sum in the loss all follow the
leaf order, so the port flattens the JAX way.  ``None`` is an empty
subtree, as in JAX, and a NamedTuple (an optimizer state such as
``optim.optimizers.AdamState``) is a node that keeps its type.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map",
           "tree_flatten_with_paths"]

PyTree = Any
# treedef: "*" for a leaf, None for None, else (kind, keys, children);
# kind is "dict", "list", "tuple" or a NamedTuple class
TreeDef = Any
_END = object()


def _walk(node, leaves: List[Any]) -> TreeDef:
    if node is None:
        return None
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return ("dict", keys, tuple(_walk(node[k], leaves) for k in keys))
    if isinstance(node, (list, tuple)):
        if isinstance(node, list):
            kind = "list"
        else:
            kind = type(node) if hasattr(node, "_fields") else "tuple"
        return (kind, len(node), tuple(_walk(c, leaves) for c in node))
    leaves.append(node)
    return "*"


def _walk_paths(node, prefix: str, out: List[Tuple[str, Any]]) -> None:
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _walk_paths(node[k], f"{prefix}{k}/", out)
        return
    if isinstance(node, (list, tuple)):
        fields = getattr(node, "_fields", None)
        for i, c in enumerate(node):
            _walk_paths(c, f"{prefix}{'.' + fields[i] if fields else i}/",
                        out)
        return
    out.append((prefix[:-1], node))


def _build(d: TreeDef, it) -> PyTree:
    if d is None:
        return None
    if d == "*":
        return next(it)
    kind, keys, children = d
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(keys, children)}
    out = [_build(c, it) for c in children]
    if kind == "list":
        return out
    return tuple(out) if kind == "tuple" else kind(*out)


# The walkers are module-level functions: a recursive closure is a
# reference cycle that would keep a flattened tree's leaves alive until the
# garbage collector runs (gigabytes, for a model's parameter tree).

def tree_flatten(tree: PyTree) -> Tuple[List[Any], TreeDef]:
    """``(leaves, treedef)``; dict keys visited in sorted order.  The
    treedef is a hashable nested tuple."""
    leaves: List[Any] = []
    treedef = _walk(tree, leaves)
    return leaves, treedef


def tree_flatten_with_paths(tree: PyTree
                            ) -> Tuple[List[Tuple[str, Any]], TreeDef]:
    """``([(path, leaf), ...], treedef)`` in ``tree_flatten`` order.  A
    path joins its keys with '/' as the reference's checkpoints key their
    leaves (``jax.tree_util.tree_flatten_with_path``): a dict key as
    itself, a list or tuple index as its number, a NamedTuple field as
    ``.name``."""
    out: List[Tuple[str, Any]] = []
    _walk_paths(tree, "", out)
    return out, tree_flatten(tree)[1]


def tree_unflatten(treedef: TreeDef, leaves) -> PyTree:
    """Inverse of ``tree_flatten``."""
    it = iter(leaves)
    out = _build(treedef, it)
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
