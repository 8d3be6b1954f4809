"""Packed client-delta layout: one flat lane-aligned buffer per *dtype
group* per round (unquantized port of ``repro.fl.packing``).

The round's D2D/D2S hot path is linear algebra over the *concatenation*
of every client's flattened delta, but the deltas live as a pytree, so a
leaf-wise implementation pays one kernel launch per leaf.  This module
flattens the tree into per-dtype ``(n, P_pad_g)`` buffers -- each P_pad_g
a multiple of 128 -- so the one-pass mixing kernels launch **once per
dtype group** (once per round for the common dtype-homogeneous tree), and
caches the layout per tree structure.

    spec  = pack_spec(deltas)          # cached per (treedef, shapes, ...)
    spec  = pack_spec(deltas, shards=k)  # every P_pad_g also divisible
                                         # into k 128-column blocks
    bufs  = pack(deltas, spec)         # tuple of (n, P_pad_g)
    tree  = unpack(bufs, spec)         # exact inverse (slices + reshapes)
    tree1 = unpack_row(rows, spec)     # per-group (P_g,) aggregate rows
                                       # -> param tree

Leaves are visited in JAX's treedef order (dict keys sorted:
``repro_torch.core.pytree``), groups are ordered by first appearance in
that order and leaves keep it inside their group, so the packed buffers,
``P_pad`` and the byte counts equal the reference's element for element.
The 128-column padding is the packed *layout* (it fixes ``P_pad`` and the
byte accounting); the CUDA kernels need no padding of their own.
Quantized payload groups (``QuantSpec``) come with the quant slice of the
port.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.pytree import tree_flatten, tree_map, tree_unflatten

PyTree = Any

__all__ = ["GroupSpec", "GroupedPackSpec", "pack_spec", "pack", "unpack",
           "unpack_row", "apply_aggregate_row", "promoted_nbytes"]

_LANE = 128


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """Static layout of ONE dtype group inside a packed delta tree.

    ``leaf_ids`` are the flat (treedef-order) indices of the leaves this
    group owns; ``shapes`` are their trailing shapes (client axis
    stripped); ``offsets[i]:offsets[i]+sizes[i]`` is leaf i's column
    range in the group's ``(n, padded)`` buffer.
    """
    dtype: torch.dtype
    leaf_ids: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    total: int          # P_g   -- sum of leaf sizes
    padded: int         # P_pad_g -- 128-aligned packed width

    @property
    def pad(self) -> int:
        return self.padded - self.total


@dataclasses.dataclass(frozen=True)
class GroupedPackSpec:
    """Static layout metadata for a packed delta tree: one ``GroupSpec``
    per distinct leaf dtype, ordered by first appearance in treedef
    order."""
    treedef: Any
    n_leaves: int
    groups: Tuple[GroupSpec, ...]

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    @property
    def total(self) -> int:
        """Total real payload columns across groups."""
        return sum(g.total for g in self.groups)

    @property
    def padded(self) -> int:
        """Total packed columns across groups (sum of the P_pad_g)."""
        return sum(g.padded for g in self.groups)

    def nbytes(self, n: int) -> int:
        """Total packed payload bytes for ``n`` clients at the groups'
        native dtypes."""
        return sum(n * g.padded * _itemsize(g.dtype) for g in self.groups)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def promoted_nbytes(spec: GroupedPackSpec, n: int,
                    align: int = _LANE) -> int:
    """Bytes the pre-grouping ONE-buffer layout would ship for ``n``
    clients: every leaf cast to the promoted dtype of the tree (fp32 if
    any leaf is fp32), 128-aligned -- the baseline for ``spec.nbytes``."""
    dt = functools.reduce(torch.promote_types,
                          [g.dtype for g in spec.groups])
    cols = ((spec.total + align - 1) // align) * align
    return n * cols * _itemsize(dt)


_SPEC_CACHE: Dict[Any, GroupedPackSpec] = {}


def pack_spec(deltas: PyTree, *, align: int = _LANE,
              shards: int = 1) -> GroupedPackSpec:
    """Build (or fetch the cached) layout spec for a per-client delta tree
    whose leaves share a leading client axis ``n``.

    Leaves are partitioned into per-dtype groups; each group packs into
    its own ``(n, P_pad_g)`` buffer at the leaves' native dtype.
    ``shards`` makes every ``P_pad_g`` a multiple of ``align * shards``
    so each buffer splits evenly into ``shards`` aligned column blocks.
    """
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    leaves, treedef = tree_flatten(deltas)
    if not leaves:
        raise ValueError("pack_spec: empty delta tree")
    shapes = tuple(tuple(l.shape[1:]) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    key = (treedef, shapes, dtypes, align, shards)
    spec = _SPEC_CACHE.get(key)
    if spec is not None:
        return spec

    by_dtype: Dict[Any, list] = {}
    for i, dt in enumerate(dtypes):         # dict preserves first-seen order
        by_dtype.setdefault(dt, []).append(i)

    unit = align * shards
    groups = []
    for dt, ids in by_dtype.items():
        gshapes = tuple(shapes[i] for i in ids)
        sizes = tuple(int(np.prod(s, dtype=np.int64)) for s in gshapes)
        offsets = tuple(int(o) for o in np.cumsum((0,) + sizes[:-1]))
        total = int(sum(sizes))
        padded = ((total + unit - 1) // unit) * unit
        groups.append(GroupSpec(dtype=dt, leaf_ids=tuple(ids),
                                shapes=gshapes, offsets=offsets,
                                sizes=sizes, total=total, padded=padded))
    spec = GroupedPackSpec(treedef=treedef, n_leaves=len(leaves),
                           groups=tuple(groups))
    _SPEC_CACHE[key] = spec
    return spec


def _validate_tree(leaves, treedef, spec: GroupedPackSpec) -> None:
    if treedef != spec.treedef or len(leaves) != spec.n_leaves:
        raise ValueError(
            "pack: delta tree does not match the spec it was built for: "
            f"spec has {spec.n_leaves} leaves / treedef {spec.treedef}, "
            f"got {len(leaves)} leaves / treedef {treedef}. Build a fresh "
            "spec with pack_spec(deltas).")
    for g in spec.groups:
        for i, shp in zip(g.leaf_ids, g.shapes):
            leaf = leaves[i]
            if tuple(leaf.shape[1:]) != shp or leaf.dtype != g.dtype:
                raise ValueError(
                    f"pack: leaf {i} has trailing shape "
                    f"{tuple(leaf.shape[1:])} / dtype {leaf.dtype}, but the "
                    f"spec expects {shp} / {g.dtype}. Build a fresh spec "
                    "with pack_spec(deltas).")


def pack(deltas: PyTree, spec: GroupedPackSpec
         ) -> Tuple[torch.Tensor, ...]:
    """Flatten the delta tree into per-dtype ``(n, P_pad_g)`` buffers (one
    per spec group, in group order).  Raises ``ValueError`` if the tree's
    structure, trailing shapes or dtypes do not match the spec."""
    leaves, treedef = tree_flatten(deltas)
    _validate_tree(leaves, treedef, spec)
    n = leaves[0].shape[0]
    bufs = []
    for g in spec.groups:
        flat = [leaves[i].reshape(n, -1) for i in g.leaf_ids]
        if g.pad:
            flat.append(leaves[g.leaf_ids[0]].new_zeros((n, g.pad)))
        bufs.append(torch.cat(flat, dim=1))
    return tuple(bufs)


def _as_group_tuple(bufs: Union[torch.Tensor, Sequence[torch.Tensor]],
                    spec: GroupedPackSpec, what: str
                    ) -> Tuple[torch.Tensor, ...]:
    """Normalize a per-group sequence (or a bare tensor for single-group
    specs) to a tuple matching ``spec.groups``."""
    if isinstance(bufs, torch.Tensor):
        bufs = (bufs,)
    bufs = tuple(bufs)
    if len(bufs) != spec.n_groups:
        raise ValueError(
            f"{what}: expected {spec.n_groups} per-group arrays "
            f"(one per dtype group), got {len(bufs)}")
    return bufs


def unpack(bufs: Union[torch.Tensor, Sequence[torch.Tensor]],
           spec: GroupedPackSpec) -> PyTree:
    """Inverse of ``pack``: per-group (n, P_pad_g) buffers -> delta tree
    (leading axis n), each leaf cast back to its group dtype."""
    bufs = _as_group_tuple(bufs, spec, "unpack")
    n = bufs[0].shape[0]
    leaves = [None] * spec.n_leaves
    for g, buf in zip(spec.groups, bufs):
        for i, o, s, shp in zip(g.leaf_ids, g.offsets, g.sizes, g.shapes):
            leaves[i] = buf[:, o:o + s].reshape((n,) + shp).to(g.dtype)
    return tree_unflatten(spec.treedef, leaves)


def unpack_row(rows: Union[torch.Tensor, Sequence[torch.Tensor]],
               spec: GroupedPackSpec) -> PyTree:
    """Unpack per-group aggregate rows -- each (P_g,) or (P_pad_g,), e.g.
    the kernels' f32 aggregates -- into a tree of per-leaf trailing shapes
    (no client axis), keeping the row dtype."""
    rows = _as_group_tuple(rows, spec, "unpack_row")
    leaves = [None] * spec.n_leaves
    for g, row in zip(spec.groups, rows):
        for i, o, s, shp in zip(g.leaf_ids, g.offsets, g.sizes, g.shapes):
            leaves[i] = row[o:o + s].reshape(shp)
    return tree_unflatten(spec.treedef, leaves)


def apply_aggregate_row(global_params: PyTree,
                        rows: Union[torch.Tensor, Sequence[torch.Tensor]],
                        spec: GroupedPackSpec) -> PyTree:
    """Eq.-4 epilogue shared by every one-pass backend: unpack the
    per-group f32 aggregate rows and add them leaf-wise, casting back to
    each global-param leaf's dtype only after the add."""
    agg = unpack_row(rows, spec)
    return tree_map(lambda g, a: (g + a).to(g.dtype), global_params, agg)
