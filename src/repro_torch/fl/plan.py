"""Declarative round plans: the whole time-varying trajectory as ONE object.

The paper's algorithm is host-side *planning* -- a trajectory of
``(A_t, tau_t, m_t, eta_t)`` chosen by the connectivity-aware rule --
executed by an interchangeable runtime.  ``RoundPlan`` reifies
that trajectory: stacked numpy columns, one row per global round, built
once on the host and handed to an ``Engine`` (``repro_torch.fl.engine``) for
execution.  Because the plan is plain host data it is also serializable
(``to_json``/``from_json``), so a training trajectory -- every topology
draw, sampling mask, step size, and dropout mask -- is a reproducible,
diffable artifact.

Columns (K = number of rounds, n = number of clients):

    A_t        (K, n, n) f32  equal-neighbor mixing matrices (eq. 2-3);
                              EITHER a dense ndarray OR a
                              ``repro_torch.core.sparse.SparseAseq`` (CSR
                              per round) -- the sparse form stores O(nnz)
                              instead of O(K n^2), so plans at
                              n = 100_000 build and serialize without
                              ever allocating an (n, n) array.  Build
                              one with ``sparse=True`` on any
                              constructor, or convert with
                              ``sparsify()``/``densify()``.
    tau_t      (K, n)    f32  0/1 PS sampling indicators (Sec. 3.3)
    m_t        (K,)      f64  eq.-4 divisor: the *effective* number of
                              sampled-and-active clients (clamped >= 1)
    eta_t      (K,)      f64  local SGD step sizes (eq. 1)
    active_t   (K, n)    f32  0/1 straggler masks: clients that finished
                              the round.  Inactive clients contribute
                              zero delta and are renormalized out of the
                              ``(tau^T A)/m`` combine row.  All-ones ==
                              the paper's full-participation setting.

plus per-round bookkeeping for ``History`` records (planned/actual
sample sizes, D2D transmission counts, the eq.-6 psi bound) and an
*optional* streaming column:

    arrival_t  (K, n)    f32  per-upload delay after round dispatch
                              (``inf`` = never delivered).  Absent
                              (None) for synchronous plans; attached by
                              ``with_faults``/``with_arrivals`` for the
                              stream engine (still to be ported) --
                              the synchronous engine ignores it.

Constructors map one-to-one onto the algorithms the server runs:

    RoundPlan.connectivity_aware(network, cfg)   Algorithm 1 / eq. 7
    RoundPlan.fedavg(network, cfg)               A = I, fixed m
    RoundPlan.colrel(network, cfg)               one D2D round, fixed m
    RoundPlan.from_rows(rows)                    any custom trajectory

``plan_rows`` is the underlying per-round generator; it consumes its
``rng`` in exactly the order the legacy sequential server loop did, so a
driver can interleave plan rows with its own draws (batch sampling) on a
shared generator and reproduce pre-plan trajectories bitwise.

Topology provenance: ``network`` is any ``repro_torch.topology`` model (the
``TopologyModel`` protocol -- ``sample(rng, t)`` may be time-correlated,
e.g. ``geometric`` mobility).  When the network exposes a serializable
``spec`` and the plan was seeded (``rng=None``), the constructors embed
``(topology, seed)`` in the plan, its JSON carries them, and
``plan.regenerate()`` rebuilds every column bitwise from the spec --
plans are *regenerable* artifacts, not only replayable ones.

Straggler support is a plan *transform*, not a runtime flag:
``plan.with_dropout(rate, rng)`` draws i.i.d. masks,
``plan.with_markov_dropout(p_fail, p_recover)`` bursty two-state chains
per client, ``plan.with_cluster_dropout(rate)`` whole-cluster outages,
and ``plan.with_active(mask)`` takes any explicit mask; all renormalize
the ``m_t``/``d2s`` bookkeeping to the surviving uploads.  The mask
generators themselves live in ``repro_torch.fl.faults`` (one rng stream shared
with the fault-injection layer); ``plan.with_faults(trace)`` applies a
full ``FaultTrace`` -- availability mask plus arrival times -- in one
transform.

Round-resumable: ``plan[t0:]`` slices the trajectory (columns +
bookkeeping preserved, ``t0`` recorded so History round indices stay
global), so a crashed run restarts mid-trajectory from a checkpoint and
matches the uninterrupted run bitwise.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import math
from typing import Iterator, Optional, Sequence, Union

import numpy as np

from repro_torch.core import sampling
from repro_torch.core.adjacency import network_matrix, network_matrix_sparse
from repro_torch.core.bounds import exact_phi_ell, \
    phi_ell_bound_from_stats, psi_total
from repro_torch.core.graphs import SparseClusterGraph
from repro_torch.core.metrics import count_d2d_transmissions
from repro_torch.core.sparse import SparseA, SparseAseq
from repro_torch.core.spans import span
from repro_torch.topology import TopologySpec

from . import faults as _faults
from .packing import QuantSpec

__all__ = ["ALGORITHMS", "PlanRow", "RoundPlan", "plan_rows"]

ALGORITHMS = ("semidec", "fedavg", "colrel")

_JSON_VERSION = 5
# v1: pre-topology plans (no embedded spec); v2: no arrival_t column;
# v3: dense-only A_t; v4: no quant config
_JSON_SUPPORTED = (1, 2, 3, 4, 5)



def _check_quant_type(quant) -> None:
    if quant is not None and not isinstance(quant, QuantSpec):
        raise ValueError(
            "quant must be a repro_torch.fl.packing.QuantSpec (or None), "
            f"got {type(quant).__name__}")


def _sample_snapshot(network, rng, t):
    """``network.sample(rng, t)`` when the sampler is time-aware (the
    ``TopologyModel`` protocol), ``network.sample(rng)`` for legacy
    custom networks."""
    sample = network.sample
    try:
        params = inspect.signature(sample).parameters
    except (TypeError, ValueError):   # pragma: no cover - builtins etc.
        params = {}
    if "t" in params or any(p.kind is inspect.Parameter.VAR_POSITIONAL
                            for p in params.values()):
        return sample(rng, t)
    return sample(rng)


def _sample_snapshot_sparse(network, rng, t):
    """Sparse cluster snapshot: ``sample_sparse`` when the model provides
    it (every ``ClusteredTopology``; identical rng consumption to
    ``sample``), else the dense snapshot converted per cluster -- (s, s)
    scratch per cluster, never anything (n, n)."""
    sample = getattr(network, "sample_sparse", None)
    if sample is not None:
        return sample(rng, t)
    return [SparseClusterGraph.from_dense(c.vertices, c.W)
            for c in _sample_snapshot(network, rng, t)]


@dataclasses.dataclass(frozen=True)
class PlanRow:
    """One global round of a trajectory (host-side, numpy)."""
    t: int
    A: Union[np.ndarray, SparseA]   # (n, n) float32 dense, or CSR
    tau: np.ndarray           # (n,)   float32
    m: float                  # eq.-4 divisor (effective sample count)
    eta: float
    active: np.ndarray        # (n,)   float32 straggler mask
    m_planned: int            # m the threshold rule asked for
    m_actual: int             # clients that actually upload
    d2s: int                  # uplink transmissions this round
    d2d: int                  # D2D transmissions this round
    psi_bound: float          # server's eq.-6 bound (NaN for baselines)


def _check_algorithm(algorithm: str, m_fixed) -> None:
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm must be one of {ALGORITHMS}")
    if algorithm in ("fedavg", "colrel") and m_fixed is None:
        raise ValueError(f"{algorithm} requires config.m_fixed")


def plan_rows(network, config, algorithm: str = "semidec",
              rng: Optional[np.random.Generator] = None, *,
              sparse: bool = False) -> Iterator[PlanRow]:
    """Generate per-round plan rows for ``network`` under ``config``.

    Replicates the legacy server loop exactly -- including rng
    consumption order (``network.sample`` then ``sample_clients``, per
    round, nothing else) -- so interleaving ``next(rows)`` with batch
    draws on a shared generator reproduces pre-RoundPlan trajectories
    bitwise.  Yields forever; take ``config.t_max`` rows (the
    ``RoundPlan`` constructors do).

    ``sparse=True`` emits rows whose ``A`` is a ``SparseA`` (CSR) built
    by ``network_matrix_sparse`` -- no (n, n) array anywhere on the
    planning path: D2D counts come off the CSR edge lists and the
    ``bound_kind`` degree-stat bounds are computed from the degree
    arrays alone (``SparseClusterGraph.stats``); ``bound_kind='exact'``
    still densifies each (s, s) cluster block (SVD needs the matrix),
    never the network.  The rng stream is consumed identically to the
    dense path, so tau/m/eta/bookkeeping columns match it bitwise and
    the ``A`` values match exactly.
    """
    _check_algorithm(algorithm, config.m_fixed)
    if rng is None:
        rng = np.random.default_rng(config.seed)
    n = network.n
    m_next = (config.m_fixed if algorithm != "semidec"
              else (config.m0 or n))
    t = 0
    while True:
        uses_d2d = algorithm in ("semidec", "colrel")
        if uses_d2d:
            if sparse:
                clusters = _sample_snapshot_sparse(network, rng, t)
                A = network_matrix_sparse(clusters, n)
                d2d = sum(c.d2d_transmissions for c in clusters)
            else:
                clusters = _sample_snapshot(network, rng, t)
                A = np.asarray(network_matrix(clusters, n), np.float32)
                d2d = sum(count_d2d_transmissions(c.W) for c in clusters)
        else:
            clusters = None
            A = SparseA.identity(n) if sparse else \
                np.eye(n, dtype=np.float32)
            d2d = 0

        psi_bound = float("nan")
        m = m_next
        if algorithm == "semidec":
            # Alg. 1 line 11: the new graph's degree stats set m for the
            # *next* sampling; for t=0 the input m(0) is used.
            if config.bound_kind == "exact":
                psis = [exact_phi_ell(c.W) for c in clusters]
            else:
                psis = [phi_ell_bound_from_stats(c.stats, config.bound_kind)
                        for c in clusters]
            sizes = [c.size for c in clusters]
            m_next = sampling.min_clients(psis, sizes, n, config.phi_max)
            if t > 0:
                m = m_next
            psi_bound = float(psi_total(m, n, psis, sizes))

        vertex_sets = ([c.vertices for c in clusters]
                       if clusters is not None else network.partition)
        tau, m_actual = sampling.sample_clients(rng, vertex_sets, m, n)
        yield PlanRow(t=t, A=A,
                      tau=np.asarray(tau, np.float32),
                      m=float(m_actual), eta=float(config.eta(t)),
                      active=np.ones(n, np.float32),
                      m_planned=int(m), m_actual=int(m_actual),
                      d2s=int(m_actual), d2d=int(d2d),
                      psi_bound=psi_bound)
        t += 1


@dataclasses.dataclass(frozen=True, eq=False)
class RoundPlan:
    """A full ``K``-round trajectory as stacked host-side columns.

    Immutable; transforms (``with_active``/``with_dropout``) return new
    plans.  Engines (``repro_torch.fl.engine``) consume the columns
    verbatim:
    the device never sees planning logic, only arrays.
    """
    algorithm: str
    A_t: Union[np.ndarray, SparseAseq]   # (K, n, n) f32 dense, or CSR
    tau_t: np.ndarray          # (K, n)    float32
    m_t: np.ndarray            # (K,)      float64
    eta_t: np.ndarray          # (K,)      float64
    active_t: np.ndarray       # (K, n)    float32
    m_planned_t: np.ndarray    # (K,)      int64
    m_actual_t: np.ndarray     # (K,)      int64
    d2s_t: np.ndarray          # (K,)      int64
    d2d_t: np.ndarray          # (K,)      int64
    psi_bound_t: np.ndarray    # (K,)      float64
    # -- streaming bookkeeping (None for synchronous plans) -------------
    arrival_t: Optional[np.ndarray] = None   # (K, n) f32, inf = lost
    # -- payload compression (None = full-precision wire) ----------------
    quant: Optional[QuantSpec] = None
    # -- provenance: who generated these columns, and from where --------
    topology: Optional[TopologySpec] = None   # embedded topology spec
    seed: Optional[int] = None     # planning seed (None: external rng)
    t0: int = 0                    # global index of row 0 (plan slices)
    source: Optional[str] = None   # None: planned/simulated columns;
    #                                'measured': arrival_t holds offsets
    #                                a live ingestion run recorded

    def __post_init__(self):
        K, n = self.A_t.shape[0], self.A_t.shape[-1]
        if self.A_t.shape != (K, n, n):
            raise ValueError(f"A_t must be (K, n, n), got {self.A_t.shape}")
        for name in ("tau_t", "active_t"):
            if getattr(self, name).shape != (K, n):
                raise ValueError(
                    f"{name} must be ({K}, {n}), got "
                    f"{getattr(self, name).shape}")
        for name in ("m_t", "eta_t", "m_planned_t", "m_actual_t",
                     "d2s_t", "d2d_t", "psi_bound_t"):
            if getattr(self, name).shape != (K,):
                raise ValueError(
                    f"{name} must be ({K},), got {getattr(self, name).shape}")
        if self.arrival_t is not None:
            if self.arrival_t.shape != (K, n):
                raise ValueError(
                    f"arrival_t must be ({K}, {n}), got "
                    f"{self.arrival_t.shape}")
            if (self.arrival_t < 0).any():
                raise ValueError("arrival_t must be non-negative")
        _check_quant_type(self.quant)
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm must be one of {ALGORITHMS}")
        if self.t0 < 0:
            raise ValueError(f"t0 must be >= 0, got {self.t0}")

    # -- shape / content views ---------------------------------------------

    @property
    def n_rounds(self) -> int:
        return int(self.A_t.shape[0])

    @property
    def n_clients(self) -> int:
        return int(self.A_t.shape[-1])

    @property
    def is_sparse(self) -> bool:
        """True iff ``A_t`` is held in CSR form (``SparseAseq``)."""
        return isinstance(self.A_t, SparseAseq)

    @property
    def has_dropout(self) -> bool:
        """True iff any client is masked out in any round.  Engines skip
        the mask plumbing entirely for all-ones plans, so the
        full-participation fast path stays bitwise-identical to the
        pre-plan runtime by construction."""
        return bool((self.active_t != 1.0).any())

    # -- round access / slicing --------------------------------------------

    def __len__(self) -> int:
        return self.n_rounds

    def __getitem__(self, idx: Union[int, slice]
                    ) -> Union[PlanRow, "RoundPlan"]:
        """``plan[t]`` -> that round's ``PlanRow`` (``t`` local to this
        plan); ``plan[t0:]`` -> the tail sub-plan: columns + bookkeeping
        sliced verbatim (nothing renumbered or renormalized), with
        ``t0`` advanced so History round indices stay global.  Resuming
        a crashed run is ``engine.execute(plan[t0:], restored_params,
        batches[t0:])`` -- bitwise-identical to the uninterrupted run.
        """
        if isinstance(idx, slice):
            start, stop, step = idx.indices(self.n_rounds)
            if step != 1:
                raise ValueError(f"plan slices must have step 1, got {step}")
            stop = max(stop, start)
            sl = slice(start, stop)
            return dataclasses.replace(
                self, A_t=self.A_t[sl], tau_t=self.tau_t[sl],
                m_t=self.m_t[sl], eta_t=self.eta_t[sl],
                active_t=self.active_t[sl],
                m_planned_t=self.m_planned_t[sl],
                m_actual_t=self.m_actual_t[sl], d2s_t=self.d2s_t[sl],
                d2d_t=self.d2d_t[sl], psi_bound_t=self.psi_bound_t[sl],
                arrival_t=(None if self.arrival_t is None
                           else self.arrival_t[sl]),
                t0=self.t0 + start)
        t = int(idx)
        if t < 0:
            t += self.n_rounds
        if not 0 <= t < self.n_rounds:
            raise IndexError(f"round {idx} out of range for "
                             f"{self.n_rounds}-round plan")
        return PlanRow(
            t=self.t0 + t, A=self.A_t[t], tau=self.tau_t[t],
            m=float(self.m_t[t]), eta=float(self.eta_t[t]),
            active=self.active_t[t], m_planned=int(self.m_planned_t[t]),
            m_actual=int(self.m_actual_t[t]), d2s=int(self.d2s_t[t]),
            d2d=int(self.d2d_t[t]), psi_bound=float(self.psi_bound_t[t]))

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_rows(cls, rows: Sequence[PlanRow], algorithm: str = "semidec",
                  topology: Optional[TopologySpec] = None,
                  seed: Optional[int] = None) -> "RoundPlan":
        """Stack explicit per-round rows into a plan (any trajectory).
        Rows carrying ``SparseA`` matrices stack into a sparse plan."""
        if not rows:
            raise ValueError("from_rows: need at least one round")
        if any(isinstance(r.A, SparseA) for r in rows):
            if not all(isinstance(r.A, SparseA) for r in rows):
                raise ValueError(
                    "from_rows: all rows must share one A representation "
                    "(got a mix of dense and SparseA)")
            A_t = SparseAseq([r.A for r in rows])
        else:
            A_t = np.stack([np.asarray(r.A, np.float32) for r in rows])
        return cls(
            algorithm=algorithm,
            A_t=A_t,
            tau_t=np.stack([np.asarray(r.tau, np.float32) for r in rows]),
            m_t=np.asarray([r.m for r in rows], np.float64),
            eta_t=np.asarray([r.eta for r in rows], np.float64),
            active_t=np.stack([np.asarray(r.active, np.float32)
                               for r in rows]),
            m_planned_t=np.asarray([r.m_planned for r in rows], np.int64),
            m_actual_t=np.asarray([r.m_actual for r in rows], np.int64),
            d2s_t=np.asarray([r.d2s for r in rows], np.int64),
            d2d_t=np.asarray([r.d2d for r in rows], np.int64),
            psi_bound_t=np.asarray([r.psi_bound for r in rows], np.float64),
            topology=topology, seed=seed,
        )

    @classmethod
    def _planned(cls, network, config, algorithm,
                 rng: Optional[np.random.Generator],
                 sparse: bool = False) -> "RoundPlan":
        # provenance: the spec always rides along when the network has
        # one; the seed only when planning owned the rng stream (an
        # external generator may have unknown prior state, so the plan
        # is then replayable but not regenerable)
        spec = getattr(network, "spec", None)
        spec = spec if isinstance(spec, TopologySpec) else None
        seed = int(config.seed) if rng is None else None
        with span("repro_torch.plan"):
            gen = plan_rows(network, config, algorithm, rng, sparse=sparse)
            return cls.from_rows([next(gen) for _ in range(config.t_max)],
                                 algorithm=algorithm, topology=spec,
                                 seed=seed)

    @classmethod
    def connectivity_aware(cls, network, config,
                           rng: Optional[np.random.Generator] = None,
                           *, sparse: bool = False) -> "RoundPlan":
        """Algorithm 1: time-varying D2D mixing + the eq.-7 m(t) rule.
        ``sparse=True`` plans in CSR -- O(nnz) memory, same rng stream
        (see ``plan_rows``)."""
        return cls._planned(network, config, "semidec", rng, sparse)

    @classmethod
    def fedavg(cls, network, config,
               rng: Optional[np.random.Generator] = None,
               *, sparse: bool = False) -> "RoundPlan":
        """McMahan et al.: no D2D (A = I), fixed ``config.m_fixed``."""
        return cls._planned(network, config, "fedavg", rng, sparse)

    @classmethod
    def colrel(cls, network, config,
               rng: Optional[np.random.Generator] = None,
               *, sparse: bool = False) -> "RoundPlan":
        """Yemini et al.: one D2D aggregation per round, fixed m."""
        return cls._planned(network, config, "colrel", rng, sparse)

    @classmethod
    def controlled(cls, network, config, controller,
                   rng: Optional[np.random.Generator] = None,
                   *, sparse: bool = False) -> "RoundPlan":
        """Offline closed-loop planning: run a ``repro_torch.control``
        policy over ``config.t_max`` rounds with no training in the loop
        (the controller sees each realized topology draw, never a
        ``RoundRecord`` or deltas) and return the realized plan.
        Controllers that learn from training feedback
        (``needs_deltas``, e.g. ``similarity``) cannot plan offline --
        run them through an engine (``FederatedServer.run(
        controller=...)``) instead."""
        from repro_torch.control import ControlLoop   # deferred: control
        # imports this module back at package init

        loop = ControlLoop(network, config, controller, rng=rng,
                           sparse=sparse)
        if loop.needs_deltas:
            raise ValueError(
                "this controller consumes per-round training feedback "
                "(needs_deltas); it cannot plan offline -- run it with "
                "FederatedServer.run(controller=...) instead")
        for _ in range(config.t_max):
            loop.next_row()
        return loop.emit_plan()

    # -- straggler transforms ----------------------------------------------

    def with_active(self, active_t: np.ndarray) -> "RoundPlan":
        """Return a plan with the given (K, n) straggler mask.

        Inactive clients contribute zero delta and never transmit, so
        the bookkeeping is renormalized on both legs: the eq.-4 divisor
        ``m_t`` and the D2S counts shrink to the surviving
        ``tau * active`` uploads (``m_t`` clamped >= 1 so an all-dropped
        round degenerates to an identity update, like the tau = 0 round
        the runtime already supports), and each round's D2D count drops
        the dropped senders' outgoing edges (the off-diagonal nonzeros
        of their ``A_t`` columns -- a silent client broadcasts nothing).
        An all-ones mask leaves every column bit-identical.
        """
        active_t = np.asarray(active_t, np.float32)
        if active_t.shape != self.tau_t.shape:
            raise ValueError(
                f"active_t must have shape {self.tau_t.shape}, got "
                f"{active_t.shape}")
        if not np.isin(active_t, (0.0, 1.0)).all():
            raise ValueError("active_t must be a 0/1 mask")
        eff = (self.tau_t * active_t).sum(axis=1)
        # A_t[i, j] != 0 iff client j transmits to i; off-diagonal
        # entries in a dropped client's column are transmissions that
        # never happen.  The sparse branch counts the same entries off
        # the CSR edge lists -- O(nnz), never densifying.
        if self.is_sparse:
            dropped_tx = np.asarray(
                [((m.data != 0.0) & (active_t[t][m.indices] == 0.0)
                  & (m.row_ids() != m.indices)).sum()
                 for t, m in enumerate(self.A_t)], np.int64)
        else:
            off_diag = (self.A_t != 0.0) \
                & ~np.eye(self.n_clients, dtype=bool)[None]
            dropped_tx = (off_diag * (active_t == 0.0)[:, None, :]) \
                .sum(axis=(1, 2))
        return dataclasses.replace(
            self, active_t=active_t,
            m_t=np.maximum(eff, 1.0).astype(np.float64),
            m_actual_t=eff.astype(np.int64),
            d2s_t=eff.astype(np.int64),
            d2d_t=np.maximum(self.d2d_t - dropped_tx.astype(np.int64), 0))

    def with_dropout(self, rate: float,
                     rng: Optional[np.random.Generator] = None
                     ) -> "RoundPlan":
        """Drop each client independently with probability ``rate`` per
        round (partial participation inside a cluster; cf. Lin et al. /
        Rodio et al.) -- one more plan column, zero runtime flags."""
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"need 0 <= rate < 1, got {rate}")
        if rng is None:
            rng = np.random.default_rng(0)
        K, n = self.tau_t.shape
        return self.with_active(_faults.iid_active(rng, K, n, rate))

    def with_markov_dropout(self, p_fail: float, p_recover: float,
                            rng: Optional[np.random.Generator] = None
                            ) -> "RoundPlan":
        """Bursty (temporally-correlated) stragglers: each client is an
        independent two-state Markov chain, failing with probability
        ``p_fail`` per round and recovering with probability
        ``p_recover`` -- mean outage length ``1/p_recover`` rounds, vs
        the memoryless single-round outages of ``with_dropout``.  The
        chain starts from its stationary distribution (long-run active
        fraction ``p_recover / (p_fail + p_recover)``), so the marginal
        dropout rate is constant from round 0.  ``p_fail = 0`` is
        bitwise-identical to full participation.
        """
        for name, p in (("p_fail", p_fail), ("p_recover", p_recover)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"need 0 <= {name} <= 1, got {p}")
        if rng is None:
            rng = np.random.default_rng(0)
        K, n = self.tau_t.shape
        return self.with_active(
            _faults.markov_active(rng, K, n, p_fail, p_recover))

    def with_cluster_dropout(self, rate: float,
                             rng: Optional[np.random.Generator] = None,
                             partition: Optional[Sequence[np.ndarray]] = None
                             ) -> "RoundPlan":
        """Whole-cluster outages: each cluster independently drops *all*
        of its clients with probability ``rate`` per round (an access
        point or relay going dark -- spatially-correlated failures the
        i.i.d. model can't express).  ``partition`` defaults to the
        embedded topology spec's t=0 membership (re-clustering schemes
        keep their base partition).
        """
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"need 0 <= rate < 1, got {rate}")
        if partition is None:
            if self.topology is None:
                raise ValueError(
                    "with_cluster_dropout needs a partition: pass one "
                    "explicitly or use a plan with an embedded topology "
                    "spec")
            partition = self.topology.build().partition
        if rng is None:
            rng = np.random.default_rng(0)
        K, n = self.tau_t.shape
        return self.with_active(
            _faults.cluster_active(rng, K, partition, n, rate))

    # -- payload-compression transform ---------------------------------------

    def with_quant(self, quant: Optional[QuantSpec]) -> "RoundPlan":
        """Attach (or clear, with None) the payload quantization config.

        Pure execution metadata -- no column changes: engines that run a
        quant-carrying plan quantize every client upload under this spec.
        An explicit ``ExecutionConfig.quant`` overrides the plan's."""
        _check_quant_type(quant)
        return dataclasses.replace(self, quant=quant)

    # -- streaming transforms ------------------------------------------------

    def with_arrivals(self, arrival_t: Optional[np.ndarray]
                      ) -> "RoundPlan":
        """Attach (or clear, with None) the per-upload arrival-delay
        column.  Pure bookkeeping: synchronous engines never read it;
        ``repro_torch.fl.stream.StreamEngine`` folds it into its
        virtual-time closure rule."""
        if arrival_t is not None:
            arrival_t = np.asarray(arrival_t, np.float32)
        return dataclasses.replace(self, arrival_t=arrival_t)

    def with_source(self, source: Optional[str]) -> "RoundPlan":
        """Tag (or clear) the provenance of the columns.  The ingestion
        runtime stamps its recordings ``'measured'`` so a plan whose
        arrival column came from wall-clock measurement is
        distinguishable from a planned/simulated one downstream."""
        return dataclasses.replace(self, source=source)

    def with_faults(self, trace) -> "RoundPlan":
        """Apply a realized ``repro_torch.fl.faults.FaultTrace``: the trace's
        availability mask (failure chains AND departures) composes into
        ``active_t`` -- renormalizing ``m_t``/``d2s``/``d2d`` exactly
        like the dropout transforms -- and its arrival delays become the
        ``arrival_t`` column.  A zero-latency trace applied here and
        run synchronously is bitwise-identical to the same trace run
        through ``StreamEngine``.
        """
        if (trace.K, trace.n) != self.tau_t.shape:
            raise ValueError(
                f"trace is ({trace.K}, {trace.n}), plan needs "
                f"{self.tau_t.shape}")
        out = self.with_active(self.active_t * trace.active)
        return out.with_arrivals(trace.arrival)

    # -- regeneration from provenance ---------------------------------------

    def regenerate(self) -> "RoundPlan":
        """Rebuild every column from the embedded topology spec.

        Replays the planning rng stream (``topology.sample`` then
        ``sample_clients`` per round, using the recorded per-round
        ``m_planned_t``), so the result is bitwise-identical to the
        original plan -- the plan JSON is a *generator* of its own
        trajectory, not only a recording.  Requires provenance: an
        embedded spec and a planning seed (and an unsliced plan, since a
        slice's rng offset is not recoverable).
        """
        if self.topology is None or self.seed is None:
            raise ValueError(
                "plan carries no regenerable provenance (topology spec + "
                "seed); plans built from an external rng or raw rows can "
                "only be replayed")
        if self.t0 != 0:
            raise ValueError("sliced plans cannot be regenerated; "
                             "regenerate the full plan and re-slice")
        model = self.topology.build()
        n = self.n_clients
        rng = np.random.default_rng(self.seed)
        uses_d2d = self.algorithm in ("semidec", "colrel")
        rows = []
        for t in range(self.n_rounds):
            if uses_d2d:
                if self.is_sparse:
                    clusters = _sample_snapshot_sparse(model, rng, t)
                    A = network_matrix_sparse(clusters, n)
                    d2d = sum(c.d2d_transmissions for c in clusters)
                else:
                    clusters = model.sample(rng, t)
                    A = np.asarray(network_matrix(clusters, n), np.float32)
                    d2d = sum(count_d2d_transmissions(c.W)
                              for c in clusters)
                vertex_sets = [c.vertices for c in clusters]
            else:
                A = (SparseA.identity(n) if self.is_sparse
                     else np.eye(n, dtype=np.float32))
                d2d = 0
                vertex_sets = model.partition
            m = int(self.m_planned_t[t])
            tau, m_actual = sampling.sample_clients(rng, vertex_sets, m, n)
            rows.append(PlanRow(
                t=t, A=A,
                tau=np.asarray(tau, np.float32), m=float(m_actual),
                eta=float(self.eta_t[t]), active=np.ones(n, np.float32),
                m_planned=m, m_actual=int(m_actual), d2s=int(m_actual),
                d2d=int(d2d), psi_bound=float(self.psi_bound_t[t])))
        base = RoundPlan.from_rows(rows, self.algorithm,
                                   topology=self.topology, seed=self.seed)
        if self.has_dropout:
            base = base.with_active(self.active_t)
        return base.with_arrivals(self.arrival_t)

    # -- representation conversions -----------------------------------------

    def sparsify(self) -> "RoundPlan":
        """The same plan with ``A_t`` in CSR form (no-op if already
        sparse).  ``sparsify().densify()`` is bitwise-identical to the
        dense original: CSR stores exactly the nonzero f32 entries."""
        if self.is_sparse:
            return self
        return dataclasses.replace(self,
                                   A_t=SparseAseq.from_dense(self.A_t))

    def densify(self) -> "RoundPlan":
        """The same plan with ``A_t`` as a dense (K, n, n) ndarray
        (no-op if already dense).  Small-n parity testing only -- this
        is the O(n^2) allocation the sparse path exists to avoid."""
        if not self.is_sparse:
            return self
        return dataclasses.replace(self, A_t=self.A_t.dense())

    # -- serialization ------------------------------------------------------

    def to_json(self) -> str:
        """Serialize the full trajectory.  Exact: every column round-trips
        bit-for-bit through ``from_json`` (f32/f64 values survive JSON's
        shortest-repr doubles), so an executed plan is a pinned artifact.
        The embedded topology spec + seed make it a regenerable one:
        ``RoundPlan.from_json(text).regenerate()`` rebuilds the columns
        from the generative model instead of reading the recording.
        """
        payload = {
            "version": _JSON_VERSION,
            "algorithm": self.algorithm,
            "n_rounds": self.n_rounds,
            "n_clients": self.n_clients,
            "topology": (None if self.topology is None
                         else self.topology.as_dict()),
            "seed": self.seed,
            "t0": self.t0,
            "source": self.source,
            # sparse plans serialize the CSR arrays (O(nnz) text, the
            # only way an n = 100_000 plan fits anywhere); dense plans
            # keep the v3 nested-list layout.
            "A_t": ({"encoding": "csr",
                     "indptr": [m.indptr.tolist() for m in self.A_t],
                     "indices": [m.indices.tolist() for m in self.A_t],
                     "data": [m.data.tolist() for m in self.A_t]}
                    if self.is_sparse else self.A_t.tolist()),
            "tau_t": self.tau_t.tolist(),
            "m_t": self.m_t.tolist(),
            "eta_t": self.eta_t.tolist(),
            "active_t": self.active_t.tolist(),
            "m_planned_t": self.m_planned_t.tolist(),
            "m_actual_t": self.m_actual_t.tolist(),
            "d2s_t": self.d2s_t.tolist(),
            "d2d_t": self.d2d_t.tolist(),
            "psi_bound_t": [None if not math.isfinite(v) else v
                            for v in self.psi_bound_t.tolist()],
            "arrival_t": (None if self.arrival_t is None else
                          [[None if not math.isfinite(v) else v
                            for v in row]
                           for row in self.arrival_t.tolist()]),
            "quant": (None if self.quant is None else self.quant.as_dict()),
        }
        return json.dumps(payload)

    @classmethod
    def from_json(cls, text: str) -> "RoundPlan":
        d = json.loads(text)
        if d.get("version") not in _JSON_SUPPORTED:
            raise ValueError(
                f"unsupported RoundPlan version {d.get('version')!r} "
                f"(supported: {_JSON_SUPPORTED})")
        spec = d.get("topology")
        A_raw = d["A_t"]
        if isinstance(A_raw, dict):
            if A_raw.get("encoding") != "csr":
                raise ValueError(
                    f"unknown A_t encoding {A_raw.get('encoding')!r}")
            n = int(d["n_clients"])
            A_t = SparseAseq(
                [SparseA(n=n, indptr=np.asarray(ip, np.int64),
                         indices=np.asarray(ix, np.int32),
                         data=np.asarray(dt, np.float32))
                 for ip, ix, dt in zip(A_raw["indptr"], A_raw["indices"],
                                       A_raw["data"])])
        else:
            A_t = np.asarray(A_raw, np.float32)
        return cls(
            topology=(None if spec is None
                      else TopologySpec.from_dict(spec)),
            seed=d.get("seed"),
            t0=int(d.get("t0", 0)),
            # absent in older payloads: provenance defaults to planned
            source=d.get("source"),
            algorithm=d["algorithm"],
            A_t=A_t,
            tau_t=np.asarray(d["tau_t"], np.float32),
            m_t=np.asarray(d["m_t"], np.float64),
            eta_t=np.asarray(d["eta_t"], np.float64),
            active_t=np.asarray(d["active_t"], np.float32),
            m_planned_t=np.asarray(d["m_planned_t"], np.int64),
            m_actual_t=np.asarray(d["m_actual_t"], np.int64),
            d2s_t=np.asarray(d["d2s_t"], np.int64),
            d2d_t=np.asarray(d["d2d_t"], np.int64),
            psi_bound_t=np.asarray(
                [math.nan if v is None else v for v in d["psi_bound_t"]],
                np.float64),
            arrival_t=(None if d.get("arrival_t") is None else
                       np.asarray([[math.inf if v is None else v
                                    for v in row]
                                   for row in d["arrival_t"]],
                                  np.float32)),
            # absent in v<=4 payloads: older plans load as unquantized
            quant=(None if d.get("quant") is None
                   else QuantSpec.from_dict(d["quant"])),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "RoundPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- comparisons (used by tests; ndarray fields defeat dataclass eq) ----

    def allclose(self, other: "RoundPlan", exact: bool = True) -> bool:
        if self.algorithm != other.algorithm:
            return False
        if self.quant != other.quant:   # frozen dataclass: field-wise eq
            return False
        if self.source != other.source:
            return False
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if isinstance(a, SparseAseq) or isinstance(b, SparseAseq):
                # representation is part of plan identity: a sparse and
                # a dense plan never compare equal (convert first)
                if not (isinstance(a, SparseAseq)
                        and isinstance(b, SparseAseq) and a.equals(b)):
                    return False
                continue
            if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                # optional columns: None on one side only is a mismatch
                if a is None or b is None:
                    return False
                if a.shape != b.shape or a.dtype != b.dtype:
                    return False
                if np.issubdtype(a.dtype, np.floating):
                    eq = (a == b) | (np.isnan(a) & np.isnan(b)) \
                        | (np.isinf(a) & np.isinf(b) & (np.sign(a)
                                                        == np.sign(b)))
                else:
                    eq = a == b
                if not eq.all():
                    return False
        return True
