"""Singular-value bounds and the connectivity factor (paper Sec. 3.3 & 5).

The server never sees the full topology -- only per-cluster degree statistics
broadcast by the access points.  From those it evaluates one of two bound
families on ``sigma_1^2 + sigma_2^2`` of the equal-neighbor matrix:

* ``psi_regular``  -- Prop. 5.1, eqs. (10)-(11): digraphs with in-degree ==
  out-degree, alpha > 1/2, eps << 1.
* ``psi_general``  -- Prop. 5.2, eqs. (15)-(16): general digraphs, alpha >= 1/2.

Note on the "-1": the paper defines ``phi_ell = sigma_1^2 + sigma_2^2 - 1``
(eq. 5) but plugs the *sum-of-squares* bounds straight into ``psi_ell``
(eq. 6), i.e. ``psi_ell`` upper-bounds ``phi_ell + 1 >= phi_ell``.  We follow
the paper verbatim (conservative), and expose ``exact_phi_ell`` for the
oracle that knows the topology.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from .adjacency import equal_neighbor_matrix, phi_ell as _phi_ell_exact
from .graphs import DegreeStats

__all__ = [
    "sigma1_sq_regular",
    "sigma2_sq_regular",
    "psi_regular",
    "sigma1_sq_general",
    "sigma2_sq_general",
    "psi_general",
    "psi_ell_from_stats",
    "phi_ell_bound_from_stats",
    "connectivity_factor",
    "psi_total",
    "exact_phi_ell",
    "exact_phi_ell_sparse",
]


# ----------------------------------------------------------------------------
# Prop. 5.1 -- approximately-regular digraphs (in-degree == out-degree).
# ----------------------------------------------------------------------------

def sigma1_sq_regular(eps: float) -> float:
    """Eq. (10): sigma_1^2 <= 1 + eps (+ O(eps^2))."""
    return 1.0 + eps


def sigma2_sq_regular(eps: float, alpha: float) -> float:
    """Eq. (11): sigma_2^2 <= (1/alpha - 1)^2 + 2 eps (1 + 2/alpha - 1/alpha^2)."""
    if alpha <= 0:
        raise ValueError("alpha must be positive")
    a_inv = 1.0 / alpha
    return (a_inv - 1.0) ** 2 + 2.0 * eps * (1.0 + 2.0 * a_inv - a_inv ** 2)


def psi_regular(stats: DegreeStats) -> float:
    """psi_ell for Prop. 5.1 (first display in eq. 6)."""
    return sigma1_sq_regular(stats.eps) + sigma2_sq_regular(stats.eps, stats.alpha)


# ----------------------------------------------------------------------------
# Prop. 5.2 -- general digraphs (alpha >= 1/2).
# ----------------------------------------------------------------------------

def sigma1_sq_general(varphi: float) -> float:
    """Eq. (15): sigma_1^2 <= 1 + varphi."""
    return 1.0 + varphi


def _general_correction(stats: DegreeStats) -> float:
    """The subtracted fraction of eq. (16).

    The expression is only meaningful when its denominator is safely
    positive (the Lynn-Timlake-based derivation assumes a strictly positive
    Perron-entry spread term).  For exactly-regular digraphs the term
    ``eps_net - alpha_{-1} + 1/(alpha s)`` collapses to 0 up to rounding, in
    which case we conservatively drop the correction (falling back to
    ``sigma_2^2 <= 1 + varphi``, which always holds since
    ``sigma_2 <= sigma_1``).  The correction is clamped to ``[0, 1+varphi]``
    so the returned sigma_2^2 bound stays in its valid range.
    """
    eps, varphi, alpha, s = stats.eps, stats.varphi, stats.alpha, stats.size
    alpha_m1 = 1.0 / alpha - 1.0                 # alpha_{-1}
    eps_net = varphi + eps / alpha               # eps_net
    num = ((1.0 - eps) ** 2 * (1.0 - alpha_m1 ** 2)
           * ((1.0 - eps) ** 2 * (1.0 - alpha_m1 ** 2) - alpha_m1))
    den = s * (eps_net + 1.0) * (eps_net - alpha_m1 + 1.0 / (alpha * s))
    if den <= 1e-9 or num < 0.0:
        return 0.0  # degenerate regime: fall back to the looser 1 + varphi
    return min(num / den, 1.0 + varphi)


def sigma2_sq_general(stats: DegreeStats) -> float:
    """Eq. (16)."""
    return 1.0 + stats.varphi - _general_correction(stats)


def psi_general(stats: DegreeStats) -> float:
    """psi_ell for Prop. 5.2 (second display in eq. 6):
    2 + 2*varphi - correction."""
    return sigma1_sq_general(stats.varphi) + sigma2_sq_general(stats)


# ----------------------------------------------------------------------------
# Server-side selection & the connectivity factor.
# ----------------------------------------------------------------------------

def psi_ell_from_stats(stats: DegreeStats, kind: str = "auto") -> float:
    """Pick the bound family the server uses (Sec. 3.3 step (2)).

    ``auto`` prefers Prop. 5.1 when its hypotheses plausibly hold
    (in-degree == out-degree signature and alpha > 1/2) and otherwise uses
    Prop. 5.2; when both apply, takes the tighter (smaller) bound.
    """
    if kind == "regular":
        return psi_regular(stats)
    if kind == "general":
        return psi_general(stats)
    if kind != "auto":
        raise ValueError(f"unknown bound kind {kind!r}")
    candidates = []
    if stats.alpha > 0.5 and stats.in_equals_out:
        candidates.append(psi_regular(stats))
    if stats.alpha >= 0.5:
        candidates.append(psi_general(stats))
    if not candidates:
        # Outside both derivation regimes: conservative sum of the generic
        # bounds that hold for any column-stochastic matrix restricted to a
        # cluster block (sigma_1^2 <= 1 + varphi still holds; sigma_2 <= sigma_1).
        candidates.append(2.0 * sigma1_sq_general(stats.varphi))
    return min(candidates)


def phi_ell_bound_from_stats(stats: DegreeStats, kind: str = "auto"
                             ) -> float:
    """Degree-only upper bound on ``phi_ell = sigma_1^2 + sigma_2^2 - 1``.

    ``psi_ell_from_stats`` bounds the *sum of squares*; since phi_ell is
    that sum minus one, ``psi_ell - 1`` is the tighter valid bound on
    phi_ell and is what the m(t) rule should compare against phi_max (the
    paper's eq. (6) carries the +1 through, which makes psi >= 1 always
    and would force m(t) = n for any phi_max < (n/(n-1) - 1); its own
    simulations clearly operate in the m << n regime, so we use the
    phi-consistent form here and keep ``kind='verbatim'`` for eq. (6) as
    printed).
    """
    if kind == "verbatim":
        return psi_ell_from_stats(stats, "auto")
    return max(psi_ell_from_stats(stats, kind) - 1.0, 0.0)


def connectivity_factor(m: int, n: int, phis: Sequence[float],
                        sizes: Sequence[int]) -> float:
    """Eq. (5): phi(t) = (n/m - 1) * sum_ell (n_ell/n) phi_ell(t)."""
    if not 1 <= m <= n:
        raise ValueError(f"need 1 <= m <= n, got m={m}, n={n}")
    mix = sum((s / n) * p for p, s in zip(phis, sizes))
    return (n / m - 1.0) * mix


def psi_total(m: int, n: int, psis: Sequence[float],
              sizes: Sequence[int]) -> float:
    """Eq. (6): the server's computable upper bound on phi(t)."""
    return connectivity_factor(m, n, psis, sizes)


def exact_phi_ell(W: np.ndarray) -> float:
    """Oracle phi_ell from the true topology (testing / oracle baselines)."""
    return _phi_ell_exact(equal_neighbor_matrix(W))


# ----------------------------------------------------------------------------
# CSR realized-phi: the oracle without densifying anything.
# ----------------------------------------------------------------------------

def _phi_from_edges(dst: np.ndarray, src: np.ndarray, w: np.ndarray,
                    s: int, iters: int, tol: float) -> float:
    """``sigma_1^2 + sigma_2^2 - 1`` of the s x s matrix with entries
    ``A[dst_k, src_k] = w_k``, by blocked subspace iteration on
    ``A^T A`` over the edge list -- O(nnz) per sweep, no (s, s) array.

    The start block is deterministic (orthonormalized cosine ramps), so
    repeated calls are bit-stable; f64 rounding inside the sweeps breaks
    any exact orthogonality to the leading invariant subspace, which
    subspace iteration then amplifies.  Degenerate sigma_2 == sigma_3
    does not stall the estimate: any vector of the degenerate subspace
    carries the same Rayleigh quotient, and only the top-two eigenvalue
    *sum* is returned.
    """
    if s == 1:
        a = float(w.sum())           # at most the single self-entry
        return a * a - 1.0
    q = min(4, s)
    i = np.arange(s, dtype=np.float64)
    V = np.stack([np.cos(np.pi * k * (i + 0.5) / s) for k in range(q)],
                 axis=1)
    V += 1e-8 * np.cos(np.outer(i + 1.0, np.arange(1, q + 1)))
    V, _ = np.linalg.qr(V)
    wc = w[:, None]
    top2 = np.zeros(2)
    for _ in range(iters):
        AV = np.zeros((s, q))
        np.add.at(AV, dst, wc * V[src])          # A @ V
        Z = np.zeros((s, q))
        np.add.at(Z, src, wc * AV[dst])          # A^T (A V)
        B = V.T @ Z                              # projected A^T A
        ev = np.sort(np.linalg.eigvalsh((B + B.T) * 0.5))[::-1]
        new_top2 = ev[:2]
        V, _ = np.linalg.qr(Z)
        if np.all(np.abs(new_top2 - top2)
                  <= tol * np.maximum(1.0, np.abs(new_top2))):
            top2 = new_top2
            break
        top2 = new_top2
    return float(top2[0] + top2[1] - 1.0)


def exact_phi_ell_sparse(g, vertices: np.ndarray = None, *,
                         iters: int = 500, tol: float = 1e-13) -> float:
    """Oracle phi_ell straight off CSR edge lists.

    ``g`` is either a ``repro_torch.core.graphs.SparseClusterGraph`` (one
    cluster's digraph; the equal-neighbor weights ``1/d_out`` are formed
    in f64 exactly like the dense path) or a ``repro_torch.core.sparse.SparseA``
    (an already-built mixing matrix, optionally restricted to the cluster
    block ``vertices`` -- the matrix must be block-diagonal there, i.e.
    no entry may couple the block to the rest).  Equals
    ``exact_phi_ell(W)`` to iteration tolerance (pinned by parity tests)
    without ever materializing an (s, s) or (n, n) array, which is what
    lets the online controller observe realized connectivity on large-n
    sparse plans.
    """
    from .graphs import SparseClusterGraph
    from .sparse import SparseA

    if isinstance(g, SparseClusterGraph):
        if vertices is not None:
            raise ValueError(
                "vertices= only applies to SparseA input; a "
                "SparseClusterGraph is already one cluster block")
        d_out = np.asarray(g.d_out, np.int64)
        if (d_out <= 0).any():
            raise ValueError("every node needs positive out-degree "
                             "(Fact 1)")
        src = np.repeat(np.arange(g.size, dtype=np.int64),
                        np.diff(g.indptr))
        dst = g.indices.astype(np.int64)
        w = 1.0 / d_out[src].astype(np.float64)
        return _phi_from_edges(dst, src, w, int(g.size), iters, tol)
    if not isinstance(g, SparseA):
        raise TypeError(
            "exact_phi_ell_sparse takes a SparseClusterGraph or SparseA, "
            f"got {type(g).__name__}")
    dst = g.row_ids().astype(np.int64)
    src = g.indices.astype(np.int64)
    w = g.data.astype(np.float64)
    if vertices is None:
        return _phi_from_edges(dst, src, w, int(g.n), iters, tol)
    verts = np.asarray(vertices, np.int64)
    lut = np.full(int(g.n), -1, np.int64)
    lut[verts] = np.arange(len(verts))
    keep = lut[dst] >= 0
    if (lut[src[keep]] < 0).any() or (lut[src] >= 0)[~keep].any():
        raise ValueError(
            "vertices must select a decoupled block: found entries "
            "coupling the block to the rest of the matrix")
    return _phi_from_edges(lut[dst[keep]], lut[src[keep]], w[keep],
                           len(verts), iters, tol)
