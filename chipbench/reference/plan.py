"""The plan's columns, checked against the paper and worked out again.

Which digraph a cluster realised in a round and which clients the server
sampled are random draws: the reference cannot draw them again, so it
reads them off the plan and checks that they are draws of the stated
kind.  Everything else it works out itself:

* each A_t is block-diagonal over the clusters (equal membership, c
  blocks of n / c), and inside a block it is the equal-neighbour matrix
  of the block's support: A[i, j] = 1 / d_j^+ on every edge j -> i,
  self-loops present (eq. 2), so every column sums to 1;
* the realised digraph is the ``k_regular`` family's: a k-regular
  digraph with self-loops, k in [k_min, min(k_max, s)], less
  round(p_fail * s (k - 1)) of its other edges;
* m_t by the threshold rule (eq. 7) on the degree bounds of Sec. 5
  (Prop. 5.1 for ``regular``, Prop. 5.2 for ``general``, the smaller
  where each applies for ``auto``; the bound on phi is psi - 1), the
  round's rule from its own graph, m(0) = n;
* tau_t samples ceil((m / n) s) clients of each cluster of size s, and
  the divisor is their number;
* eta_t by the configuration's schedule.

``check_plan`` returns the number of violations and the rounds as the
reference uses them: its own A (float64), tau, m and eta.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np

__all__ = ["check_plan", "psi", "min_clients"]


def _stats(d_out: np.ndarray, d_in: np.ndarray, s: int) -> Dict:
    lo = int(d_out.min())
    return {"s": s, "alpha": lo / s,
            "eps": (int(d_out.max()) - lo) / lo,
            "varphi": (int(d_in.max()) - lo) / lo,
            "in_equals_out": int(d_in.max()) == int(d_out.max())}


def _psi_regular(st: Dict) -> float:
    """Prop. 5.1, eqs. (10)-(11): sigma_1^2 + sigma_2^2 <= 1 + eps +
    (1/alpha - 1)^2 + 2 eps (1 + 2/alpha - 1/alpha^2)."""
    a, e = 1.0 / st["alpha"], st["eps"]
    return 1.0 + e + (a - 1.0) ** 2 + 2.0 * e * (1.0 + 2.0 * a - a * a)


def _psi_general(st: Dict) -> float:
    """Prop. 5.2, eqs. (15)-(16): 2 (1 + varphi) less eq. (16)'s
    correction, which is taken only where its denominator is positive
    and its numerator non-negative, and at most 1 + varphi."""
    eps, vphi, alpha, s = st["eps"], st["varphi"], st["alpha"], st["s"]
    am1 = 1.0 / alpha - 1.0
    eps_net = vphi + eps / alpha
    core = (1.0 - eps) ** 2 * (1.0 - am1 ** 2)
    num = core * (core - am1)
    den = s * (eps_net + 1.0) * (eps_net - am1 + 1.0 / (alpha * s))
    corr = 0.0 if (den <= 1e-9 or num < 0.0) else min(num / den, 1.0 + vphi)
    return 2.0 * (1.0 + vphi) - corr


def psi(st: Dict, kind: str) -> float:
    if kind == "regular":
        return _psi_regular(st)
    if kind == "general":
        return _psi_general(st)
    if kind != "auto":
        raise ValueError(f"unknown bound kind {kind!r}")
    cands = []
    if st["alpha"] > 0.5 and st["in_equals_out"]:
        cands.append(_psi_regular(st))
    if st["alpha"] >= 0.5:
        cands.append(_psi_general(st))
    return min(cands) if cands else 2.0 * (1.0 + st["varphi"])


def min_clients(phis: List[float], sizes: List[int], n: int,
                phi_max: float) -> int:
    """Eq. (7): the least r in [1, n] with (n / r - 1) sum_l (s_l / n)
    phi_l <= phi_max."""
    S = sum((s / n) * p for p, s in zip(phis, sizes))
    if S <= 0:
        return 1
    for r in range(1, n + 1):
        if (n / r - 1.0) * S <= phi_max:
            return r
    return n


def _family_ok(sup: np.ndarray, s: int, k_min: int, k_max: int,
               p_fail: float) -> bool:
    """A k-regular digraph with self-loops, less round(p s (k - 1)) of
    its other edges, for some k the family allows."""
    if not np.all(np.diag(sup)):
        return False
    other = int(sup.sum()) - s
    if int(sup.sum(0).max()) > k_max or int(sup.sum(1).max()) > k_max:
        return False
    for k in range(k_min, min(k_max, s) + 1):
        full = s * (k - 1)
        if other == full - int(round(p_fail * full)):
            return True
    return False


def check_plan(cols: Dict[str, np.ndarray], s: Dict,
               eta: Callable[[int], float]) -> Tuple[int, List[str],
                                                     List[Dict]]:
    n, c = s["n_clients"], s["clusters"]
    size = n // c
    blocks = [np.arange(l * size, (l + 1) * size) for l in range(c)]
    bad: List[str] = []
    rounds = []
    R = cols["A_t"].shape[0]
    for t in range(R):
        A = cols["A_t"][t].astype(np.float64)
        ref = np.zeros((n, n))
        mask = np.zeros((n, n), bool)
        phis = []
        for v in blocks:
            blk = A[np.ix_(v, v)]
            mask[np.ix_(v, v)] = True
            sup = blk != 0
            d_out = sup.sum(0)             # column j: j's out-edges
            d_in = sup.sum(1)
            if not _family_ok(sup, size, s["k_min"], s["k_max"],
                              s["p_fail"]):
                bad.append(f"round {t}: a cluster's digraph is not of the "
                           "k_regular family")
            if (d_out == 0).any():
                bad.append(f"round {t}: a client with no out-edge")
                d_out = np.maximum(d_out, 1)
            want = sup / d_out[None, :]
            if np.abs(blk - want).max() > 1e-7:
                bad.append(f"round {t}: A is not the equal-neighbour matrix "
                           f"(max gap {np.abs(blk - want).max():.3e})")
            ref[np.ix_(v, v)] = want
            phis.append(max(psi(_stats(d_out, d_in, size),
                                s["bound_kind"]) - 1.0, 0.0))
        if np.any(A[~mask] != 0):
            bad.append(f"round {t}: A couples clusters")
        if np.abs(ref.sum(0) - 1.0).max() > 1e-12:
            bad.append(f"round {t}: A is not column-stochastic")
        m = n if t == 0 else min_clients(phis, [size] * c, n, s["phi_max"])
        if int(cols["m_planned_t"][t]) != m:
            bad.append(f"round {t}: m planned {int(cols['m_planned_t'][t])},"
                       f" the rule gives {m}")
        tau = cols["tau_t"][t].astype(np.float64)
        if not np.all((tau == 0) | (tau == 1)):
            bad.append(f"round {t}: tau is not 0/1")
        for v in blocks:
            want_l = min(size, math.ceil((m / n) * size))
            if int(tau[v].sum()) != want_l:
                bad.append(f"round {t}: a cluster sampled "
                           f"{int(tau[v].sum())} clients, not {want_l}")
        m_div = float(tau.sum())
        if float(cols["m_t"][t]) != m_div:
            bad.append(f"round {t}: divisor {float(cols['m_t'][t])}, "
                       f"{m_div} clients sampled")
        e = float(eta(t))
        if abs(float(cols["eta_t"][t]) - e) > 1e-12 * abs(e):
            bad.append(f"round {t}: eta {float(cols['eta_t'][t])}, the "
                       f"schedule gives {e}")
        if np.any(cols["active_t"][t] != 1):
            bad.append(f"round {t}: a client is dropped")
        rounds.append({"A": ref, "tau": tau, "m": m_div, "eta": e})
    return len(bad), bad, rounds
