"""Client sampling at the PS (paper Sec. 3.3 & Alg. 1 lines 8-11).

Two pieces:

* ``min_clients`` -- the connectivity-aware threshold rule (7):
  ``m(t+1) = min { r in [n] : psi(r, alpha_1..alpha_c) <= phi_max }``.
* ``sample_clients`` -- proportional per-cluster uniform sampling:
  cluster ``ell`` contributes ``ceil((m/n) * n_ell)`` clients chosen
  uniformly at random, guaranteeing every cluster representation
  proportional to its size.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from .bounds import psi_total

__all__ = ["min_clients", "sample_clients"]


def min_clients(psis: Sequence[float], sizes: Sequence[int], n: int,
                phi_max: float) -> int:
    """Smallest r with (n/r - 1) * S <= phi_max, where
    S = sum_ell (n_ell/n) psi_ell.

    psi(r) is monotone decreasing in r and psi(n) = 0 <= phi_max, so a
    solution always exists.  Solved in closed form (r >= n*S/(phi_max + S))
    and verified, which matches the paper's linear scan exactly.
    """
    if phi_max < 0:
        raise ValueError("phi_max must be >= 0")
    S = sum((s / n) * p for p, s in zip(psis, sizes))
    if S <= 0:
        return 1
    if phi_max == 0:
        return n
    r = max(1, min(n, math.ceil(n * S / (phi_max + S))))
    # Guard against float edge cases at the boundary.
    while r < n and psi_total(r, n, psis, sizes) > phi_max:
        r += 1
    while r > 1 and psi_total(r - 1, n, psis, sizes) <= phi_max:
        r -= 1
    return r


def sample_clients(rng: np.random.Generator,
                   cluster_vertices: Sequence[np.ndarray],
                   m: int, n: int) -> Tuple[np.ndarray, int]:
    """Proportional per-cluster uniform sampling (Sec. 3.3 step (1)).

    Returns ``(tau, m_actual)`` where ``tau`` is the 0/1 indicator vector of
    length ``n`` (tau_i = |{i} ∩ S(t)|) and ``m_actual = tau.sum()`` --
    ceil-ing per cluster can make it slightly exceed ``m``; the aggregation
    rule (4) always divides by the *actual* number of sampled clients.
    """
    if not 1 <= m <= n:
        raise ValueError(f"need 1 <= m <= n, got m={m}")
    tau = np.zeros(n, dtype=np.float64)
    for verts in cluster_vertices:
        n_ell = len(verts)
        m_ell = min(n_ell, math.ceil((m / n) * n_ell))
        chosen = rng.choice(np.asarray(verts), size=m_ell, replace=False)
        tau[chosen] = 1.0
    return tau, int(tau.sum())
