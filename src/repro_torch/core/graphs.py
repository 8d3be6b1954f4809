"""Time-varying directed D2D cluster graphs (paper Sec. 2.2, 6.1.1).

This module holds the graph *primitives* (adjacency constructors, degree
statistics, ``ClusterGraph``); graph *generation* is the declarative
``repro_torch.topology`` registry (the reference's deprecated ``D2DNetwork``
shim is not ported: build networks from a ``TopologySpec``).

All host-side server math is numpy (the parameter server is the host); the
round functions in ``repro_torch.core.rounds`` consume the resulting dense
arrays as device tensors.

Conventions
-----------
``W`` is the binary adjacency matrix of a cluster digraph with ``W[i, j] = 1``
iff there is a communication link *from* client ``i`` *to* client ``j``
(``i`` is an in-neighbor of ``j``).  Out-degree of ``i`` is ``W[i].sum()``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

__all__ = [
    "DegreeStats",
    "ClusterGraph",
    "SparseClusterGraph",
    "k_regular_digraph",
    "delete_edge_fraction",
    "ensure_positive_out_degree",
    "degree_stats",
    "degree_stats_from_arrays",
]


@dataclasses.dataclass(frozen=True)
class DegreeStats:
    """Degree statistics of one cluster digraph (paper Sec. 3.3 / Sec. 5)."""

    size: int               # n_ell -- number of clients in the cluster
    d_min_out: int          # d^+_min
    d_max_out: int          # d^+_max
    d_max_in: int           # d^-_max (called d^in_max in Prop. 5.2)
    alpha: float            # d^+_min / n_ell   (minimum out-degree fraction)
    eps: float              # (d^+_max - d^+_min) / d^+_min
    varphi: float           # (d^-_max - d^+_min) / d^+_min

    @property
    def in_equals_out(self) -> bool:  # pragma: no cover - trivial
        return self.d_max_in == self.d_max_out


def degree_stats_from_arrays(d_out: np.ndarray,
                             d_in: np.ndarray) -> DegreeStats:
    """Degree statistics straight from the out-/in-degree arrays.

    This is the whole server-side theory input (Sec. 3.3 / Sec. 5): the
    eq.-7 control law never needs the adjacency matrix itself, only node
    degrees -- so the sparse topology path feeds this directly from its
    CSR row counts without ever densifying."""
    d_out = np.asarray(d_out, dtype=int)
    d_in = np.asarray(d_in, dtype=int)
    s = len(d_out)
    d_min_out = int(d_out.min())
    d_max_out = int(d_out.max())
    d_max_in = int(d_in.max())
    if d_min_out <= 0:
        raise ValueError("cluster digraph has a node with zero out-degree; "
                         "apply ensure_positive_out_degree first")
    return DegreeStats(
        size=s,
        d_min_out=d_min_out,
        d_max_out=d_max_out,
        d_max_in=d_max_in,
        alpha=d_min_out / s,
        eps=(d_max_out - d_min_out) / d_min_out,
        varphi=(d_max_in - d_min_out) / d_min_out,
    )


def degree_stats(W: np.ndarray) -> DegreeStats:
    """Compute the degree statistics the server learns from the access point."""
    W = np.asarray(W)
    return degree_stats_from_arrays(W.sum(axis=1), W.sum(axis=0))


def k_regular_digraph(s: int, k: int, rng: np.random.Generator,
                      self_loops: bool = True) -> np.ndarray:
    """Random k-regular digraph: every in-degree and out-degree equals ``k``.

    Construction: the union of ``k`` disjoint permutation digraphs.  Each
    permutation contributes exactly one out-edge and one in-edge per node, so
    the union (when the permutations place no two edges on the same (i, j)
    pair) is k-regular.  With ``self_loops=True`` the identity permutation is
    always included (clients keep a share of their own gradient), matching
    the consensus-style aggregation of eq. (2) where a client's own update
    re-enters through the mixing.
    """
    if not 1 <= k <= s:
        raise ValueError(f"need 1 <= k <= s, got k={k}, s={s}")
    W = np.zeros((s, s), dtype=np.int8)
    perms: List[np.ndarray] = []
    if self_loops:
        perms.append(np.arange(s))
        W[np.arange(s), np.arange(s)] = 1
    # Derangement-style shifts composed with random relabelings give disjoint
    # permutations cheaply and deterministically terminate.
    relabel = rng.permutation(s)
    shift = 1
    while len(perms) < k:
        if shift >= s:
            raise ValueError(f"cannot build {k}-regular digraph on {s} nodes")
        perm = relabel[(np.argsort(relabel) + shift) % s]
        cols = perm
        rows = np.arange(s)
        if W[rows, cols].any():  # pragma: no cover - defensive; shifts are disjoint
            shift += 1
            continue
        W[rows, cols] = 1
        perms.append(perm)
        shift += 1
    assert (W.sum(axis=1) == k).all() and (W.sum(axis=0) == k).all()
    return W


def delete_edge_fraction(W: np.ndarray, p: float,
                         rng: np.random.Generator,
                         protect_self_loops: bool = True,
                         self_loops: bool = True) -> np.ndarray:
    """Delete a fraction ``p`` of directed edges uniformly at random.

    Models D2D link failures from client mobility / bandwidth issues
    (paper Sec. 6.1.1 step (ii)).  Self-loops model a client's possession of
    its own gradient and cannot "fail", so they are protected by default.

    ``self_loops`` is forwarded to ``ensure_positive_out_degree``: graphs
    generated without self-loops must not regain one through the
    isolated-node repair.
    """
    if not 0.0 <= p < 1.0:
        raise ValueError(f"need 0 <= p < 1, got {p}")
    W = np.array(W, copy=True)
    rows, cols = np.nonzero(W)
    if protect_self_loops:
        keep = rows != cols
        rows, cols = rows[keep], cols[keep]
    n_edges = len(rows)
    n_delete = int(round(p * n_edges))
    if n_delete:
        idx = rng.choice(n_edges, size=n_delete, replace=False)
        W[rows[idx], cols[idx]] = 0
    return ensure_positive_out_degree(W, self_loops=self_loops)


def ensure_positive_out_degree(W: np.ndarray,
                               self_loops: bool = True) -> np.ndarray:
    """Guarantee every node has out-degree >= 1 (needed for column
    stochasticity of the equal-neighbor matrix).

    The repair edge respects the graph's self-loop policy: with
    ``self_loops=True`` (the default, rng-stream- and bitwise-identical
    to the historical behavior) an isolated node gets its self-loop
    back; with ``self_loops=False`` it gets a deterministic non-self
    edge to its successor ``(i + 1) % s`` instead -- except on a
    single-node graph, where the self-loop is the only edge that exists
    (the one case the policy cannot be honored).
    """
    W = np.array(W, copy=True)
    dead = W.sum(axis=1) == 0
    if dead.any():
        idx = np.nonzero(dead)[0]
        s = W.shape[0]
        if self_loops or s == 1:
            W[idx, idx] = 1
        else:
            W[idx, (idx + 1) % s] = 1
    return W


@dataclasses.dataclass(frozen=True)
class ClusterGraph:
    """One strongly-connected-component snapshot (V_ell(t), E_ell(t))."""

    vertices: np.ndarray       # global client indices, shape (n_ell,)
    W: np.ndarray              # binary adjacency, shape (n_ell, n_ell)

    @property
    def size(self) -> int:
        return len(self.vertices)

    @property
    def stats(self) -> DegreeStats:
        return degree_stats(self.W)


@dataclasses.dataclass(frozen=True)
class SparseClusterGraph:
    """One cluster snapshot in CSR form: row ``i`` lists client ``i``'s
    out-neighbors (``indices[indptr[i]:indptr[i+1]]``, local ids, sorted
    ascending -- the row-major order of ``np.nonzero`` on the dense
    ``W``, so sparse and dense constructions enumerate edges
    identically).

    This is the first-class representation for large-``n`` topologies:
    every registered family's row holds only its actual out-edges (a
    k-regular row has ``k`` entries, a ``ring`` row ``hops + 1``), the
    degree statistics the eq.-7 control law needs come straight from the
    row pointers (``stats``), and the global sparse mixing matrix
    (``repro_torch.core.adjacency.network_matrix_sparse``) assembles from
    these blocks without ever materializing an ``(n, n)`` array.  The
    dense ``W`` property densifies only the ``(s, s)`` cluster block --
    exact-SVD oracles stay cheap because clusters are small even when
    ``n`` is not.
    """

    vertices: np.ndarray       # global client indices, shape (n_ell,)
    indptr: np.ndarray         # (n_ell + 1,) int64 row pointers
    indices: np.ndarray        # (nnz,) int32 local out-neighbor ids

    @property
    def size(self) -> int:
        return len(self.vertices)

    @property
    def nnz(self) -> int:
        return len(self.indices)

    @property
    def d_out(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    @property
    def d_in(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.size) \
            .astype(np.int64)

    @property
    def d2d_transmissions(self) -> int:
        """Directed transmissions = edges minus self-loops (matches
        ``repro_torch.core.metrics.count_d2d_transmissions`` on the dense W)."""
        rows = np.repeat(np.arange(self.size), self.d_out)
        return int(self.nnz - int((self.indices == rows).sum()))

    @property
    def stats(self) -> DegreeStats:
        """Degree statistics without densifying (the sparse theory path)."""
        return degree_stats_from_arrays(self.d_out, self.d_in)

    @property
    def W(self) -> np.ndarray:
        """The dense (s, s) binary block (small: clusters stay tens of
        nodes even at million-client n)."""
        s = self.size
        W = np.zeros((s, s), dtype=np.int8)
        rows = np.repeat(np.arange(s), self.d_out)
        W[rows, self.indices] = 1
        return W

    def dense(self) -> ClusterGraph:
        return ClusterGraph(vertices=self.vertices, W=self.W)

    @classmethod
    def from_dense(cls, vertices: np.ndarray,
                   W: np.ndarray) -> "SparseClusterGraph":
        W = np.asarray(W)
        rows, cols = np.nonzero(W)
        indptr = np.zeros(W.shape[0] + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=W.shape[0]), out=indptr[1:])
        return cls(vertices=np.asarray(vertices),
                   indptr=indptr, indices=cols.astype(np.int32))
