"""Registered time-varying graph families (port of
``repro.topology.families``: numpy, the same rng draw order, so a seed
gives bitwise the reference's snapshots).

Every family produces per-cluster binary adjacency matrices with
positive out-degrees (required by the equal-neighbor matrix, Fact 1) and
self-loops by default (a client keeps a share of its own gradient,
eq. 2).  Degree-stat regimes -- what each family exercises in the
Sec. 5 bound machinery:

    family       regime
    -----------  -------------------------------------------------------
    k_regular    the paper's Sec. 6.1.1 model: eps = 0 before deletion,
                 Prop. 5.1 territory (alpha = k/s, in == out degrees)
    erdos_renyi  i.i.d. directed G(s, p): binomial degree spread, alpha
                 typically < 1/2 -> the conservative fallback bound
    geometric    unit-square disk graphs with random-waypoint mobility:
                 *time-correlated* G(t) (consecutive snapshots share
                 most edges), spatially clustered degrees
    ring         sparse deterministic worst case: out-degree hops+1,
                 alpha ~ 2/s -> psi near its maximum, m(t) -> n
    small_world  ring lattice + Watts-Strogatz rewiring: interpolates
                 ring -> random as beta goes 0 -> 1
    hub          star-like: spokes touch only the hub(s); d_in(hub) ~ s
                 (varphi ~ s/2), the D2S-degenerate extreme
    preferential_attachment
                 Barabasi-Albert-style directed growth: newcomers attach
                 ``m_edges`` out-edges with probability proportional to
                 in-degree + 1 -> scale-free in-degree tail (early nodes
                 accumulate most links), heavy-tail stress for varphi
    learned      Dada-style collaboration graph (Zantedeschi et al.,
                 AISTATS 2020): each client keeps out-edges to its top-k
                 most-similar peers under an externally-pushed
                 similarity matrix (``set_similarity``, fed by the
                 ``similarity`` controller from inter-client delta
                 cosines); a deterministic ring before the first push
    measured_trace
                 replays a recorded per-round edge list (e.g. extracted
                 from a realized ``RoundPlan`` or a wall-clock
                 ``Recording`` via ``MeasuredTrace.from_plan``):
                 rng-free, so measured contact traces become first-class
                 specs that regenerate bitwise; empty trace falls back
                 to the deterministic 1-hop ring
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.graphs import (SparseClusterGraph,
                                     delete_edge_fraction,
                                     ensure_positive_out_degree,
                                     k_regular_digraph)

from .base import ClusteredTopology, register

__all__ = ["KRegular", "ErdosRenyi", "Geometric", "Ring", "SmallWorld",
           "Hub", "PreferentialAttachment", "Learned", "MeasuredTrace"]


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


@register("erdos_renyi")
class ErdosRenyi(ClusteredTopology):
    """Directed G(s, p) per cluster: each off-diagonal edge present
    independently with probability ``p_edge``."""

    DEFAULTS: Dict = {"p_edge": 0.5, "self_loops": True}

    def _cluster_W(self, rng, t, verts):
        p = self._params
        s = len(verts)
        W = (rng.random((s, s)) < float(p["p_edge"])).astype(np.int8)
        np.fill_diagonal(W, 1 if p["self_loops"] else 0)
        return ensure_positive_out_degree(W, self_loops=bool(p["self_loops"]))


@register("geometric")
class Geometric(ClusteredTopology):
    """Random geometric graphs on the unit square under random-waypoint
    mobility: client ``i`` links to ``j`` iff ``||pos_i - pos_j|| <=
    radius`` (plus self-loops).  Positions persist across rounds and
    move ``speed`` per round toward a waypoint (redrawn on arrival), so
    consecutive snapshots are genuinely *time-correlated* -- unlike
    every i.i.d. family, G(t+1) shares most of G(t)'s edges.

    rng consumption per round is shape-only (one (n,2) uniform per
    advance regardless of arrivals), so a seeded stream regenerates the
    trajectory exactly.
    """

    DEFAULTS: Dict = {"radius": 0.35, "speed": 0.08, "self_loops": True}
    time_correlated = True

    def _reset(self, rng):
        self._pos = rng.random((self.n, 2))
        self._way = rng.random((self.n, 2))

    def _advance(self, rng, t):
        speed = float(self._params["speed"])
        step = self._way - self._pos
        dist = np.linalg.norm(step, axis=1)
        arrived = dist <= speed
        scale = np.where(arrived, 1.0, speed / np.maximum(dist, 1e-12))
        self._pos = self._pos + step * scale[:, None]
        fresh = rng.random((self.n, 2))    # fixed-shape draw every round
        self._way = np.where(arrived[:, None], fresh, self._way)

    def _cluster_W(self, rng, t, verts):
        p = self._params
        pos = self._pos[verts]
        d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
        W = (d <= float(p["radius"])).astype(np.int8)
        np.fill_diagonal(W, 1 if p["self_loops"] else 0)
        return ensure_positive_out_degree(W, self_loops=bool(p["self_loops"]))


@register("ring")
class Ring(ClusteredTopology):
    """Deterministic directed ring: ``i -> i+1, ..., i+hops`` (mod s)
    plus self-loops.  The sparse worst case for the psi bounds: alpha ~
    (hops+1)/s, so the m(t) rule is pushed toward full participation."""

    DEFAULTS: Dict = {"hops": 1, "self_loops": True}

    def _cluster_W(self, rng, t, verts):
        p = self._params
        s = len(verts)
        hops = max(1, int(p["hops"]))
        W = np.zeros((s, s), dtype=np.int8)
        idx = np.arange(s)
        for h in range(1, min(hops, max(s - 1, 1)) + 1):
            W[idx, (idx + h) % s] = 1
        if p["self_loops"] or s == 1:
            np.fill_diagonal(W, 1)
        return ensure_positive_out_degree(
            W, self_loops=bool(p["self_loops"]))

    def _cluster_sparse(self, rng, t, verts):
        # Deterministic family: emit CSR directly, no (s, s) scratch.
        # Pinned equal (densified) to _cluster_W in tests/test_sparse.py.
        p = self._params
        s = len(verts)
        if s == 1:
            return SparseClusterGraph(
                vertices=np.asarray(verts),
                indptr=np.array([0, 1], dtype=np.int64),
                indices=np.zeros(1, dtype=np.int32))
        hops = min(max(1, int(p["hops"])), s - 1)
        i = np.arange(s, dtype=np.int64)[:, None]
        cols = (i + np.arange(1, hops + 1, dtype=np.int64)[None, :]) % s
        if p["self_loops"]:
            cols = np.concatenate([i, cols], axis=1)
        cols = np.sort(cols, axis=1)
        d = cols.shape[1]
        return SparseClusterGraph(
            vertices=np.asarray(verts),
            indptr=np.arange(0, (s + 1) * d, d, dtype=np.int64),
            indices=cols.ravel().astype(np.int32))


@register("small_world")
class SmallWorld(ClusteredTopology):
    """Watts-Strogatz-style: a ``hops``-neighbor ring lattice whose
    non-self edges each rewire to a uniform random target with
    probability ``beta`` (collisions keep the original edge).  beta=0 is
    the ring; beta=1 approaches a sparse random digraph."""

    DEFAULTS: Dict = {"hops": 2, "beta": 0.2, "self_loops": True}

    def _cluster_W(self, rng, t, verts):
        p = self._params
        s = len(verts)
        hops = max(1, int(p["hops"]))
        beta = float(p["beta"])
        W = np.zeros((s, s), dtype=np.int8)
        idx = np.arange(s)
        for h in range(1, min(hops, max(s - 1, 1)) + 1):
            W[idx, (idx + h) % s] = 1
        if beta > 0 and s > 2:
            rows, cols = np.nonzero(W)
            for i, j in zip(rows, cols):
                if rng.random() >= beta:
                    continue
                jn = int(rng.integers(s))
                if jn != i and jn != int(j) and not W[i, jn]:
                    W[i, j] = 0
                    W[i, jn] = 1
        if p["self_loops"] or s == 1:
            np.fill_diagonal(W, 1)
        return ensure_positive_out_degree(
            W, self_loops=bool(p["self_loops"]))


@register("hub")
class Hub(ClusteredTopology):
    """Star-like intra-cluster graph: the first ``hubs`` clients of each
    cluster are hubs, linked to every spoke in both directions (hubs
    also interlink); spokes touch only hubs (+ their self-loop).  The
    D2S-degenerate extreme: d_in(hub) ~ s makes varphi ~ s/hubs, so the
    degree-only bounds blow up and m(t) collapses to ~n even though the
    exact phi can be moderate."""

    DEFAULTS: Dict = {"hubs": 1, "self_loops": True}

    def _cluster_W(self, rng, t, verts):
        p = self._params
        s = len(verts)
        h = max(1, min(int(p["hubs"]), s))
        W = np.zeros((s, s), dtype=np.int8)
        W[:, :h] = 1                        # everyone transmits to hubs
        W[:h, :] = 1                        # hubs transmit to everyone
        np.fill_diagonal(W, 1 if p["self_loops"] else 0)
        return ensure_positive_out_degree(
            W, self_loops=bool(p["self_loops"]))

    def _cluster_sparse(self, rng, t, verts):
        # Deterministic family: emit CSR directly, no (s, s) scratch.
        # Pinned equal (densified) to _cluster_W in tests/test_sparse.py.
        p = self._params
        s = len(verts)
        h = max(1, min(int(p["hubs"]), s))
        self_loops = bool(p["self_loops"])
        rows = []
        for i in range(s):
            if i < h:
                cols = np.arange(s, dtype=np.int32)
                if not self_loops:
                    cols = np.delete(cols, i)
            else:
                cols = np.arange(h, dtype=np.int32)
                if self_loops:
                    cols = np.append(cols, np.int32(i))
            if cols.size == 0:      # singleton cluster, self_loops=False
                cols = np.zeros(1, dtype=np.int32)
            rows.append(cols)
        indptr = np.zeros(s + 1, dtype=np.int64)
        np.cumsum([r.size for r in rows], out=indptr[1:])
        return SparseClusterGraph(vertices=np.asarray(verts),
                                  indptr=indptr,
                                  indices=np.concatenate(rows))


@register("preferential_attachment")
class PreferentialAttachment(ClusteredTopology):
    """Directed Barabasi-Albert-style growth per cluster: the first
    ``seed_clique`` nodes form a clique, then each newcomer ``i``
    attaches ``m_edges`` out-edges to distinct earlier nodes drawn with
    probability proportional to ``in-degree + 1``.  Rich-get-richer:
    in-degrees develop a scale-free tail (early nodes hoard links) while
    out-degrees stay ~``m_edges`` -- the heavy-tailed ``d_max_in`` /
    ``varphi`` regime between the balanced k-regular model and the
    degenerate hub extreme."""

    DEFAULTS: Dict = {"m_edges": 2, "seed_clique": 3, "self_loops": True}

    def _cluster_sparse(self, rng, t, verts):
        # Native CSR growth -- edge lists only, no (s, s) scratch.
        # _cluster_W derives from this (the reverse of the default), so
        # dense and sparse snapshots share one rng stream trivially.
        p = self._params
        s = len(verts)
        if s == 1:
            return SparseClusterGraph(
                vertices=np.asarray(verts),
                indptr=np.array([0, 1], dtype=np.int64),
                indices=np.zeros(1, dtype=np.int32))
        self_loops = bool(p["self_loops"])
        c0 = max(2, min(int(p["seed_clique"]), s))
        m_edges = max(1, int(p["m_edges"]))
        d_in = np.zeros(s, dtype=np.int64)
        rows = []
        for i in range(c0):
            cols = np.arange(c0, dtype=np.int64)
            if not self_loops:
                cols = np.delete(cols, i)
            rows.append(cols)
        d_in[:c0] = c0 if self_loops else c0 - 1
        for i in range(c0, s):
            k = min(m_edges, i)
            wts = d_in[:i] + 1.0
            targets = np.sort(rng.choice(i, size=k, replace=False,
                                         p=wts / wts.sum()).astype(np.int64))
            d_in[targets] += 1
            if self_loops:
                targets = np.append(targets, i)   # i > targets: stays sorted
                d_in[i] += 1
            rows.append(targets)
        indptr = np.zeros(s + 1, dtype=np.int64)
        np.cumsum([r.size for r in rows], out=indptr[1:])
        return SparseClusterGraph(vertices=np.asarray(verts),
                                  indptr=indptr,
                                  indices=np.concatenate(rows)
                                  .astype(np.int32))

    def _cluster_W(self, rng, t, verts):
        return self._cluster_sparse(rng, t, verts).W


@register("learned")
class Learned(ClusteredTopology):
    """Learned collaboration graph (Dada-style; Zantedeschi et al.,
    AISTATS 2020): every client keeps out-edges to its ``k``
    most-similar peers inside its cluster, under an externally-pushed
    (n, n) similarity matrix -- ``set_similarity(S)``, which the
    ``similarity`` controller feeds from EMA cosine similarity of client
    deltas, alternating model steps and graph steps.  Before the first
    push (and again after the ``t = 0`` trajectory reset) the graph is a
    deterministic ``k``-hop ring, so the family also works standalone.

    Consumes NO rng: given the pushed similarity sequence the trajectory
    is fully determined (ties break by stable argsort on column index),
    which is what keeps controller-emitted realized plans replayable.
    ``time_correlated`` marks the external state: sampling requires
    consecutive ``t`` and a fresh model knows no similarity, so adaptive
    plans are replayable artifacts but not regenerable from spec alone.
    """

    DEFAULTS: Dict = {"k": 3, "self_loops": True}
    time_correlated = True

    def __init__(self, spec):
        super().__init__(spec)
        self._S = None

    def _reset(self, rng):
        self._S = None

    def set_similarity(self, S: np.ndarray) -> None:
        """Push a fresh (n, n) inter-client similarity matrix; the next
        snapshot rebuilds every cluster's top-k out-edges from it."""
        S = np.asarray(S, np.float64)
        if S.shape != (self.n, self.n):
            raise ValueError(
                f"similarity must be ({self.n}, {self.n}), got {S.shape}")
        self._S = S

    def _cluster_W(self, rng, t, verts):
        p = self._params
        s = len(verts)
        self_loops = bool(p["self_loops"])
        W = np.zeros((s, s), dtype=np.int8)
        if s == 1:
            W[0, 0] = 1
            return W
        k = min(max(1, int(p["k"])), s - 1)
        if self._S is None:
            idx = np.arange(s)
            for h in range(1, k + 1):
                W[idx, (idx + h) % s] = 1
        else:
            S = np.array(self._S[np.ix_(verts, verts)], np.float64)
            np.fill_diagonal(S, -np.inf)     # top-k over *peers*
            top = np.argsort(-S, axis=1, kind="stable")[:, :k]
            np.put_along_axis(W, top, np.int8(1), axis=1)
        if self_loops:
            np.fill_diagonal(W, 1)
        return ensure_positive_out_degree(W, self_loops=self_loops)


@register("measured_trace")
class MeasuredTrace(ClusteredTopology):
    """Replays a recorded per-round edge list instead of sampling one.

    ``edges`` is a per-round tuple of global directed ``(i, j)`` pairs
    -- the shape ``MeasuredTrace.from_plan`` extracts from a realized
    ``RoundPlan`` (including the measured plans inside wall-clock
    ``Recording`` artifacts), turning observed contact traces into
    first-class topology specs: JSON-serializable, registry-built, and
    consumed by the same planner as every generative family.

    Consumes NO rng, so regeneration is trivially bitwise.  Round ``t``
    indexes the trace modulo its length when ``wrap`` (a periodic
    contact schedule), else clamps to the last recorded round.  An empty
    trace degrades to the deterministic 1-hop ring (the same standalone
    fallback ``learned`` uses), which is what the registry-wide property
    suites exercise under default parameters.
    """

    DEFAULTS: Dict = {"edges": (), "wrap": True, "self_loops": True}

    def _round_pairs(self, t):
        edges = self._params["edges"]
        if not edges:
            return None
        k = (t % len(edges)) if self._params["wrap"] \
            else min(t, len(edges) - 1)
        return edges[k]

    def _cluster_W(self, rng, t, verts):
        p = self._params
        s = len(verts)
        self_loops = bool(p["self_loops"])
        W = np.zeros((s, s), dtype=np.int8)
        pairs = self._round_pairs(int(t))
        if pairs is None:
            idx = np.arange(s)
            W[idx, (idx + 1) % s] = 1
        else:
            local = {int(v): k for k, v in enumerate(verts)}
            for i, j in pairs:
                li, lj = local.get(int(i)), local.get(int(j))
                if li is not None and lj is not None:
                    W[li, lj] = 1
        if self_loops:
            np.fill_diagonal(W, 1)
        return ensure_positive_out_degree(W, self_loops=self_loops)

    @classmethod
    def from_plan(cls, plan, *, wrap: bool = True):
        """A ``TopologySpec`` whose trajectory replays ``plan``'s mixing
        support: round ``t``'s edge list is the nonzero pattern of
        ``A_t[t]`` (self-loops carried explicitly, so the rebuilt
        equal-neighbor matrices match the plan's row support exactly).
        The spec is built with ``c=1``: the recorded pattern is already
        block-diagonal over whatever clustering produced it, and
        equal-neighbor normalization only ever sees in-row (hence
        in-cluster) entries, so one global cluster reconstructs the same
        matrices without having to replay membership churn."""
        from .base import make_spec
        A = plan.A_t.dense() if plan.is_sparse else np.asarray(plan.A_t)
        # A[i, j] = W[j, i] / d_j^+ (equal-neighbor): the W edge behind a
        # nonzero mixing entry runs source j -> destination i
        edges = tuple(
            tuple((int(j), int(i)) for i, j in np.argwhere(A[t] != 0))
            for t in range(A.shape[0]))
        return make_spec("measured_trace", n=plan.n_clients, c=1,
                         edges=edges,
                         wrap=wrap, self_loops=False)
