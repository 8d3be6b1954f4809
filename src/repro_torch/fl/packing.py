"""Packed client-delta layout: one flat lane-aligned buffer per *dtype
group* per round, and the quantized wire format of those buffers (port of
``repro.fl.packing``).

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

Quantized payload groups (``QuantSpec``): ``pack_spec(..., quant=)``
additionally makes every ``P_pad_g`` a multiple of ``quant.block``;
``quantize_packed`` turns the packed buffers into the wire format
(stored int8 / nibble-packed int4 / float8_e4m3fn containers plus fp32
per-block scales) with error-feedback residuals, and the kernels of
``repro_torch.kernels.mixing`` consume that format directly.  The
quantizer is plain PyTorch, with the reference's arithmetic (absmax /
qmax, a true division, round half to even, clip, cast), so its stored
containers and scales are bitwise the reference's for nearest rounding.

Stochastic rounding draws its ``U[0, 1)`` noise from a ``torch.Generator``
on the payload's device, seeded from ``(quant.seed, counter, group)``
(``_group_generator``), not from the reference's threefry keys: porting
threefry bitwise would tie the port to one ``jax_threefry_partitionable``
setting.  The quantizer state is ``(residuals, (seed, counter))``; the
counter advances once per stochastic round, as the reference splits its
key once per round.  Stochastic trajectories therefore differ from the
reference's draw for draw; they are held to their own properties (each
value is ``floor(y)`` or ``floor(y) + 1``, unbiased, replayable, scanned
== sequential).  Nearest-rounding trajectories do not depend on the key.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.pytree import tree_flatten, tree_map, tree_unflatten

PyTree = Any

__all__ = ["GroupSpec", "GroupedPackSpec", "QuantSpec", "pack_spec",
           "pack", "unpack", "unpack_row", "apply_aggregate_row",
           "promoted_nbytes", "quantize_group", "dequantize_group",
           "quantize_packed", "dequantize_packed", "init_quant_state"]

_LANE = 128

QUANT_STORAGES = ("int8", "int4", "fp8")


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Per-group payload quantization: how a packed ``(n, P_pad_g)``
    delta buffer is compressed for the wire.

    Every group buffer is split into column blocks of ``block`` values;
    each (client, block) pair gets one fp32 absmax scale
    ``s = max|x| / qmax`` and the block is stored as ``round(x / s)`` in
    the ``storage`` container:

      'int8'  -- one int8 per value, qmax 127
      'int4'  -- two values packed per int8 byte (low nibble = even
                 column, sign-extended on unpack), qmax 7
      'fp8'   -- float8_e4m3fn per value, qmax 448 (rounding is the
                 cast's round-to-nearest, so ``rounding='stochastic'``
                 is rejected)

    ``rounding='stochastic'`` replaces round-to-nearest with the
    unbiased ``floor(y + u)``, ``u ~ U[0, 1)`` (module docstring: the
    port's generator).  ``error_feedback`` keeps a client-side fp32
    residual ``r``: each round quantizes ``x + r`` and carries ``r' =
    (x + r) - dequant(quantize(x + r))`` forward.  ``seed`` seeds the
    stochastic-rounding stream.
    """
    storage: str = "int8"
    block: int = 512
    rounding: str = "nearest"
    error_feedback: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.storage not in QUANT_STORAGES:
            raise ValueError(
                f"storage must be one of {QUANT_STORAGES}, "
                f"got {self.storage!r}")
        if self.rounding not in ("nearest", "stochastic"):
            raise ValueError(
                "rounding must be 'nearest' or 'stochastic', "
                f"got {self.rounding!r}")
        if self.storage == "fp8" and self.rounding == "stochastic":
            raise ValueError(
                "stochastic rounding is defined on the integer grids "
                "only; fp8 storage rounds via the e4m3 cast")
        unit = 2 * _LANE if self.storage == "int4" else _LANE
        if self.block <= 0 or self.block % unit:
            raise ValueError(
                f"block must be a positive multiple of {unit} for "
                f"{self.storage!r} storage (lane alignment of the stored "
                f"container), got {self.block}")

    @property
    def qmax(self) -> float:
        return {"int8": 127.0, "int4": 7.0, "fp8": 448.0}[self.storage]

    @property
    def bits(self) -> int:
        """Stored bits per payload value (4 for the nibble-packed int4)."""
        return 4 if self.storage == "int4" else 8

    @property
    def storage_dtype(self) -> torch.dtype:
        """Container dtype of the stored buffer (int8 holds two nibbles
        for 'int4')."""
        return torch.float8_e4m3fn if self.storage == "fp8" else torch.int8

    def stored_cols(self, p: int) -> int:
        """Container columns holding ``p`` payload columns."""
        return p * self.bits // 8

    def as_dict(self) -> dict:
        return {"storage": self.storage, "block": self.block,
                "rounding": self.rounding,
                "error_feedback": self.error_feedback, "seed": self.seed}

    @classmethod
    def from_dict(cls, d: dict) -> "QuantSpec":
        return cls(storage=d["storage"], block=int(d["block"]),
                   rounding=d["rounding"],
                   error_feedback=bool(d["error_feedback"]),
                   seed=int(d["seed"]))


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
    quant: Optional[QuantSpec] = None

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

    def scales_nbytes(self, n: int) -> int:
        """Side-buffer bytes: one fp32 scale per (client, block)."""
        if self.quant is None:
            return 0
        return sum(n * (g.padded // self.quant.block) * 4
                   for g in self.groups)

    def quantized_nbytes(self, n: int) -> int:
        """Compressed bytes on the wire for ``n`` clients: the stored
        containers plus the fp32 scale side buffers.  Requires a
        ``quant`` spec."""
        if self.quant is None:
            raise ValueError(_NO_QUANT)
        return sum(n * self.quant.stored_cols(g.padded)
                   for g in self.groups) + self.scales_nbytes(n)


_NO_QUANT = ("spec has no quant config; build one with "
             "pack_spec(deltas, quant=QuantSpec(...))")


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
              shards: int = 1,
              quant: Optional[QuantSpec] = None) -> GroupedPackSpec:
    """Build (or fetch the cached) layout spec for a per-client delta tree
    whose leaves share a leading client axis ``n`` (only shapes and
    dtypes are read, so ``meta`` tensors do).

    Leaves are partitioned into per-dtype groups; each group packs into
    its own ``(n, P_pad_g)`` buffer at the leaves' native dtype.
    ``shards`` makes every ``P_pad_g`` a multiple of ``align * shards``
    so each buffer splits evenly into ``shards`` aligned column blocks.
    ``quant`` attaches a ``QuantSpec``: every ``P_pad_g`` becomes a
    multiple of ``lcm(align * shards, quant.block)`` so the per-block
    scales tile the buffers exactly.
    """
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    leaves, treedef = tree_flatten(deltas)
    if not leaves:
        raise ValueError("pack_spec: empty delta tree")
    shapes = tuple(tuple(l.shape[1:]) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    key = (treedef, shapes, dtypes, align, shards, quant)
    spec = _SPEC_CACHE.get(key)
    if spec is not None:
        return spec

    by_dtype: Dict[Any, list] = {}
    for i, dt in enumerate(dtypes):         # dict preserves first-seen order
        by_dtype.setdefault(dt, []).append(i)

    unit = align * shards
    if quant is not None:
        unit = int(np.lcm(unit, quant.block))
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
                           groups=tuple(groups), quant=quant)
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


# ---------------------------------------------------------------------------
# Payload quantization (QuantSpec): pack-time compression + error feedback
# ---------------------------------------------------------------------------


def _pack_nibbles(v: torch.Tensor) -> torch.Tensor:
    """(n, p) int8 values in [-8, 7] -> (n, p//2) packed bytes: column
    2j in the low nibble, 2j+1 in the high nibble of byte j."""
    n, p = v.shape
    pairs = v.reshape(n, p // 2, 2)
    return (pairs[..., 0] & 0x0F) | (pairs[..., 1] << 4)


def _unpack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_pack_nibbles``: sign-extend both nibbles of every
    byte and re-interleave -- (n, p//2) int8 -> (n, p) int8."""
    lo = (q << 4) >> 4            # shift out the high nibble, extend back
    hi = q >> 4                   # arithmetic shift sign-extends
    return torch.stack([lo, hi], dim=-1).reshape(q.shape[0], -1)


def _group_generator(key: Tuple[int, int], group: int,
                     device: torch.device,
                     client: Optional[int] = None) -> torch.Generator:
    """The stochastic-rounding generator of one group in one round:
    ``key = (seed, counter)`` and the group index -- and, for one
    client's row quantized alone (the mesh runtime), the client index --
    mixed into one 64-bit seed by numpy's ``SeedSequence`` (module
    docstring)."""
    seed, counter = key
    words = [int(seed), int(counter), int(group)]
    if client is not None:
        words.append(int(client))
    state = np.random.SeedSequence(words)
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0]))
    return g


def quantize_group(buf: torch.Tensor, quant: QuantSpec,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize one group buffer ``(n, P)`` (``P % quant.block == 0``).

    Returns ``(stored, scales)``: the storage container
    ``(n, quant.stored_cols(P))`` and the fp32 per-block scales
    ``(n, P // quant.block)``.  An all-zero block gets scale 0 and
    dequantizes to exact zeros.  ``generator`` (a ``torch.Generator`` on
    ``buf``'s device) is required for, and only used by, stochastic
    rounding."""
    n, p = buf.shape
    if p % quant.block:
        raise ValueError(
            f"group width {p} is not a multiple of quant.block "
            f"{quant.block}; build the spec with pack_spec(..., quant=)")
    nb = p // quant.block
    x = buf.float().reshape(n, nb, quant.block)
    # a true division: PyTorch's CUDA kernel multiplies by the reciprocal
    # of a Python-number divisor, one ulp off a division now and then
    qmax = torch.full((), quant.qmax, dtype=torch.float32, device=x.device)
    scales = torch.amax(x.abs(), dim=2) / qmax                # (n, nb)
    y = x / torch.where(scales > 0, scales, 1.0)[:, :, None]
    if quant.storage == "fp8":
        # |y| <= 448 by construction, where the cast agrees with jax's
        return y.reshape(n, p).to(quant.storage_dtype), scales
    if quant.rounding == "stochastic":
        if generator is None:
            raise ValueError("stochastic rounding needs a generator")
        u = torch.rand(y.shape, generator=generator, device=y.device)
        v = torch.floor(y + u)
    else:
        v = torch.round(y)                                   # half to even
    v = torch.clamp(v, -quant.qmax, quant.qmax)
    v = v.to(torch.int8).reshape(n, p)
    return (_pack_nibbles(v) if quant.storage == "int4" else v), scales


def dequantize_group(stored: torch.Tensor, scales: torch.Tensor,
                     quant: QuantSpec) -> torch.Tensor:
    """Exact inverse mapping of ``quantize_group``'s grid: fp32
    ``(n, P)`` = stored values * per-block scales, one rounded fp32
    product per value -- the arithmetic the dequant kernels apply in
    registers (``kernels/csrc/quant_mixing.cu``)."""
    n = stored.shape[0]
    nb = scales.shape[1]
    if quant.storage == "int4":
        v = _unpack_nibbles(stored).float()
    else:
        v = stored.float()
    x = v.reshape(n, nb, quant.block) * scales[:, :, None]
    return x.reshape(n, nb * quant.block)


def quantize_packed(bufs: Sequence[torch.Tensor], spec: GroupedPackSpec,
                    residuals: Optional[Sequence[torch.Tensor]] = None,
                    key: Optional[Tuple[int, int]] = None,
                    client: Optional[int] = None):
    """Quantize every packed group buffer under ``spec.quant``.

    ``residuals`` (per-group fp32 ``(n, P_pad_g)``, or None) is the
    error-feedback state: when given, each group quantizes
    ``x + residual``.  ``key = (seed, counter)`` seeds stochastic
    rounding, one generator per group (and per ``client`` when one
    client's row is quantized alone).  Returns ``(stored, scales,
    new_residuals)`` with ``new_residuals[g] = (x_g + r_g) -
    dequant(stored_g)`` -- the exact fp32 round-trip error, always
    computed so the caller decides whether to carry it."""
    quant = spec.quant
    if quant is None:
        raise ValueError(_NO_QUANT)
    bufs = _as_group_tuple(bufs, spec, "quantize_packed")
    stored, scales, new_res = [], [], []
    for i, buf in enumerate(bufs):
        x = buf.float()
        if residuals is not None:
            x = x + residuals[i]
        gen = (None if key is None
               else _group_generator(key, i, x.device, client))
        s, sc = quantize_group(x, quant, gen)
        stored.append(s)
        scales.append(sc)
        new_res.append(x - dequantize_group(s, sc, quant))
    return tuple(stored), tuple(scales), tuple(new_res)


def dequantize_packed(stored: Sequence[torch.Tensor],
                      scales: Sequence[torch.Tensor],
                      spec: GroupedPackSpec) -> Tuple[torch.Tensor, ...]:
    """Per-group fp32 ``(n, P_pad_g)`` buffers reconstructed from the
    wire format -- the einsum oracle's inverse; the kernel backends never
    materialize these."""
    stored = _as_group_tuple(stored, spec, "dequantize_packed")
    return tuple(dequantize_group(s, sc, spec.quant)
                 for s, sc in zip(stored, scales))


def init_quant_state(spec: GroupedPackSpec, n: int, device=None):
    """Fresh client-side quantizer state ``(residuals, (seed, counter))``:
    zero error-feedback residuals (one fp32 buffer per group, packed
    layout, on ``device``) and the stochastic-rounding key, counter 0.
    Round 0 with zero residuals is plain quantization."""
    if spec.quant is None:
        raise ValueError(_NO_QUANT)
    residuals = tuple(torch.zeros((n, g.padded), dtype=torch.float32,
                                  device=device) for g in spec.groups)
    return residuals, (spec.quant.seed, 0)
