"""Equal-neighbor column-stochastic adjacency matrices (paper Sec. 3.2).

``A(t)`` encodes the D2D aggregation rule (2):

    Delta_i = sum_{j in N_i^-(t)} (1 / d_j^+(t)) (x_j^{(t,T)} - x^{(t)}),

i.e. ``A[i, j] = W[j, i] / d_j^+`` -- client ``j`` transmits an equal share
of its scaled cumulative gradient to each of its out-neighbors.  ``A(t)`` is
column-stochastic (Fact 1) and block-diagonal over clusters.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .graphs import ClusterGraph, SparseClusterGraph
from .sparse import SparseA

__all__ = [
    "equal_neighbor_matrix",
    "block_diagonal",
    "network_matrix",
    "network_matrix_sparse",
    "top_singular_values",
    "phi_ell",
    "is_column_stochastic",
]


def equal_neighbor_matrix(W: np.ndarray) -> np.ndarray:
    """A[i, j] = W[j, i] / d_j^+ ; requires every out-degree >= 1."""
    W = np.asarray(W, dtype=np.float64)
    d_out = W.sum(axis=1)
    if (d_out <= 0).any():
        raise ValueError("equal-neighbor matrix needs positive out-degrees")
    return W.T / d_out[None, :]


def block_diagonal(blocks: Sequence[np.ndarray]) -> np.ndarray:
    """Assemble the network-wide A(t) from per-cluster blocks."""
    n = sum(b.shape[0] for b in blocks)
    A = np.zeros((n, n), dtype=np.float64)
    o = 0
    for b in blocks:
        s = b.shape[0]
        A[o:o + s, o:o + s] = b
        o += s
    return A


def network_matrix(clusters: Sequence[ClusterGraph], n: int) -> np.ndarray:
    """Network-wide A(t) in *global client indexing* (handles arbitrary
    vertex partitions, e.g. after client mobility reshuffles clusters)."""
    A = np.zeros((n, n), dtype=np.float64)
    for cg in clusters:
        block = equal_neighbor_matrix(cg.W)
        A[np.ix_(cg.vertices, cg.vertices)] = block
    return A


def network_matrix_sparse(clusters: Sequence[SparseClusterGraph],
                          n: int) -> SparseA:
    """Sparse network-wide A(t) in global client indexing.

    The equal-neighbor rule ``A[i, j] = W[j, i] / d_j^+`` turns each
    cluster's CSR out-edge list (row j -> targets i) into destination-row
    entries directly; total work is O(nnz), and nothing ``(n, n)`` is
    ever allocated.  ``network_matrix(...)`` on the densified clusters
    produces the exact same values (pinned in tests/test_sparse.py).
    """
    dsts: List[np.ndarray] = []
    srcs: List[np.ndarray] = []
    wts: List[np.ndarray] = []
    for cg in clusters:
        d_out = cg.d_out
        if (d_out <= 0).any():
            raise ValueError(
                "equal-neighbor matrix needs positive out-degrees")
        verts = np.asarray(cg.vertices)
        src_local = np.repeat(np.arange(cg.size), d_out)
        dsts.append(verts[cg.indices])
        srcs.append(verts[src_local])
        # float64 division then f32 cast, matching the dense pipeline
        # (network_matrix computes in f64, plan columns store f32)
        wts.append((1.0 / d_out[src_local]).astype(np.float32))
    if dsts:
        dst = np.concatenate(dsts)
        src = np.concatenate(srcs)
        data = np.concatenate(wts)
    else:
        dst = src = np.array([], dtype=np.int64)
        data = np.array([], dtype=np.float32)
    return SparseA.from_edges(n, dst, src, data)


def top_singular_values(A: np.ndarray, k: int = 2) -> np.ndarray:
    """Greatest ``k`` singular values of ``A`` (full SVD; cluster blocks are
    small -- tens of nodes -- so this is exact and cheap on the host)."""
    s = np.linalg.svd(np.asarray(A, dtype=np.float64), compute_uv=False)
    return s[:k]


def phi_ell(A_block: np.ndarray) -> float:
    """phi_ell(t) = sigma_1^2 + sigma_2^2 - 1 for one cluster block (eq. 5)."""
    s = top_singular_values(A_block, 2)
    s2 = float(s[1]) if len(s) > 1 else 0.0
    return float(s[0]) ** 2 + s2 ** 2 - 1.0


def is_column_stochastic(A: np.ndarray, atol: float = 1e-9) -> bool:
    A = np.asarray(A)
    return bool((A >= -atol).all()
                and np.allclose(A.sum(axis=0), 1.0, atol=atol))
