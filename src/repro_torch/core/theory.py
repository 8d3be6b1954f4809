"""Theorem 4.5: convergence-rate bound and the theory-driven step size
(numpy-only copy of ``repro.core.theory``).

Implements
    t1    = floor( 4(1 - 1/T) + (16T + 8 phi_max)(beta/mu)^2 + 1 )
    eta_t = 4 / (T mu (t + t1))
and the O(1/t) optimality-gap envelope (9), against which measured
optimality gaps are overlaid.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["TheoryConstants", "t1_threshold", "eta_schedule", "gap_bound"]

_E = math.e


@dataclasses.dataclass(frozen=True)
class TheoryConstants:
    """Problem constants of Assumptions 1-3 and Lemma 4.1."""

    mu: float          # strong convexity
    beta: float        # smoothness
    rho: float         # SGD noise std bound (varrho)
    delta: float       # gradient diversity constant (eq. 8)
    gamma: float       # Gamma = f(x*) - (1/n) sum_i min f_i
    n: int             # number of clients
    T: int             # local SGD iterations per round


def t1_threshold(c: TheoryConstants, phi_max: float) -> int:
    kappa2 = (c.beta / c.mu) ** 2
    return int(math.floor(4.0 * (1.0 - 1.0 / c.T)
                          + (16.0 * c.T + 8.0 * phi_max) * kappa2 + 1.0))


def eta_schedule(c: TheoryConstants, phi_max: float):
    """Returns eta(t) = 4 / (T mu (t + t1)).

    ``t`` may be a scalar or an ndarray of rounds: scalar calls return a
    python float computed by the same IEEE ops as always (bit-identical
    to the historical scalar-only closure), array calls vectorize (the
    envelope of a whole run, per-round eta re-derivation).
    """
    t1 = t1_threshold(c, phi_max)

    def eta(t):
        out = 4.0 / (c.T * c.mu * (np.asarray(t, np.float64) + t1))
        return float(out) if out.ndim == 0 else out

    return eta


def gap_bound(c: TheoryConstants, phi_max: float, gap0: float,
              t: np.ndarray) -> np.ndarray:
    """RHS of eq. (9): expected optimality gap bound at round(s) ``t``."""
    t = np.asarray(t, dtype=np.float64)
    t1 = float(t1_threshold(c, phi_max))
    r = c.rho / c.mu
    d = c.delta / c.mu

    term1 = (t1 / (t + t1)) ** 2 * gap0
    term2 = 16.0 * (r ** 2 / (c.n * c.T) + 6.0 * c.beta * c.gamma
                    / (c.T * c.mu ** 2)) / (t + t1)
    inner = (2.0 / c.T * r ** 2
             + 4.0 * _E / c.T * (r ** 2 + 2.0 * d ** 2)
             + 6.0 * d ** 2)
    term3 = (32.0 * c.T + 16.0 * phi_max) * inner / (t + t1)
    return term1 + term2 + term3
