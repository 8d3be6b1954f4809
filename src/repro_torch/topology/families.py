"""Registered time-varying graph families.

Every family produces per-cluster binary adjacency matrices with
positive out-degrees (required by the equal-neighbor matrix, Fact 1) and
self-loops by default (a client keeps a share of its own gradient,
eq. 2).  Ported so far:

    family       regime
    -----------  -------------------------------------------------------
    k_regular    the paper's Sec. 6.1.1 model: eps = 0 before deletion,
                 Prop. 5.1 territory (alpha = k/s, in == out degrees)

The reference's other families (``base.NOT_YET_PORTED``) raise on
``make_spec``/``build`` until their slice of the port.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.core.graphs import delete_edge_fraction, k_regular_digraph

from .base import ClusteredTopology, register

__all__ = ["KRegular"]


@register("k_regular")
class KRegular(ClusteredTopology):
    """The paper's generative model (Sec. 6.1.1): per cluster, a random
    k-regular digraph with ``k`` uniform on ``k_range`` (inclusive),
    then i.i.d. deletion of a fraction ``p_fail`` of edges.

    Bitwise-reproduces the legacy ``D2DNetwork.sample`` rng stream: the
    per-cluster draw order (k, permutation digraph, edge deletion) is
    unchanged, so pre-redesign trajectories regenerate identically.
    """

    DEFAULTS: Dict = {"k_range": (6, 7, 8, 9), "p_fail": 0.1,
                      "self_loops": True}

    def _cluster_W(self, rng, t, verts):
        p = self._params
        s = len(verts)
        k_range = p["k_range"]
        k = int(rng.integers(min(k_range), max(k_range) + 1))
        # A union of k distinct shift permutations reaches at most s
        # targets with self-loops (shifts 0..s-1) but only s - 1 without
        # (shift 0 is forbidden), so tiny clusters must clamp harder.
        # A singleton cluster has no non-self target at all: force the
        # self-loop there, as a positive out-degree is non-negotiable
        # (Fact 1).
        self_loops = bool(p["self_loops"]) or s == 1
        k = min(k, s if self_loops else s - 1)
        W = k_regular_digraph(s, k, rng, self_loops=self_loops)
        if p["p_fail"] > 0:
            W = delete_edge_fraction(W, float(p["p_fail"]), rng,
                                     self_loops=self_loops)
        return W
