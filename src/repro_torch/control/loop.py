"""ControlLoop: the incremental, controller-driven row generator (numpy-only
copy of ``repro.control.loop``).

``repro_torch.fl.plan.plan_rows`` builds a whole trajectory open-loop;
``ControlLoop`` builds it one round at a time with a policy in the
loop.  Each ``next_row()`` call:

1. samples the topology snapshot (identical rng consumption to
   ``plan_rows``: topology draw, then client sampling, nothing else --
   controllers never touch the stream);
2. digests it into a ``RealizedRound`` (bound psis, the open-loop
   ``m_rule``, and -- only when the policy asked -- realized
   per-cluster ``exact_phi_ell``, computed CSR-natively on the sparse
   path so the controller never densifies ``A_t``);
3. asks the controller for a ``Decision`` and realizes it: client
   sampling at the decided m, optional gossip powering / relay-scheme
   masking of the mixing matrix, optional eta override;
4. emits a ``PlanRow`` -- the exact shape the engines consume -- plus a
   realized-connectivity telemetry dict for the round's
   ``RoundRecord``.

``emit_plan()`` stacks the generated rows into a replayable
``RoundPlan`` artifact: running it through a synchronous engine
reproduces the controlled run bitwise (the ``engine.last_realized_plan``
discipline).  When the loop owned a seeded rng and the policy left the
graph untouched (``static``, or ``threshold`` -- any policy with
``tau = 1``, ``scheme = 'all'``, and no learned-graph feedback), the
plan also carries ``(topology, seed)`` provenance and *regenerates*
bitwise from spec, because ``RoundPlan.regenerate`` replays the rng with
the recorded per-round ``m_planned_t``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np

from repro_torch.core import sampling
from repro_torch.core.adjacency import network_matrix, network_matrix_sparse
from repro_torch.core.bounds import exact_phi_ell, exact_phi_ell_sparse, \
    phi_ell_bound_from_stats, psi_total
from repro_torch.core.metrics import count_d2d_transmissions
from repro_torch.core.sparse import SparseA
from repro_torch.fl.plan import PlanRow, RoundPlan, _sample_snapshot, \
    _sample_snapshot_sparse
from repro_torch.topology import TopologySpec

from .base import Controller, ControllerSpec, Decision, RealizedRound, \
    build as _build, parse_spec as _parse_spec

__all__ = ["ControlLoop"]


def _resolve(controller: Union[str, ControllerSpec, Controller]
             ) -> Controller:
    if isinstance(controller, Controller):
        return controller
    if isinstance(controller, ControllerSpec):
        return _build(controller)
    if isinstance(controller, str):
        return _build(_parse_spec(controller))
    raise TypeError(
        "controller must be a family string ('threshold:phi_max=0.2'), a "
        f"ControllerSpec, or a Controller, got {type(controller).__name__}")


class ControlLoop:
    """Per-round planning with a policy in the loop (see module
    docstring).  ``rng=None`` seeds a fresh ``default_rng(config.seed)``
    -- the regenerable case; an external generator makes the run
    replayable only (unknown prior state), exactly like the ``RoundPlan``
    constructors."""

    def __init__(self, network, config,
                 controller: Union[str, ControllerSpec, Controller],
                 algorithm: str = "semidec",
                 rng: Optional[np.random.Generator] = None, *,
                 sparse: bool = False):
        if algorithm != "semidec":
            raise ValueError(
                "controllers drive the connectivity-aware algorithm only "
                f"(algorithm='semidec'), got {algorithm!r}")
        self.network = network
        self.config = config
        self.algorithm = algorithm
        self.controller = _resolve(controller)
        self._sparse = bool(sparse)
        self._seeded = rng is None
        self._rng = (np.random.default_rng(config.seed) if rng is None
                     else rng)
        self.controller.reset(network, config)
        self._m0 = int(config.m0 or network.n)
        self._t = 0
        self._rows: List[PlanRow] = []
        self._last_record = None
        # provenance flags: emitted A == what regenerate() would rebuild?
        self._pristine = True
        self._graph_fed = (self.controller.needs_deltas
                           and hasattr(network, "set_similarity"))

    # -- surface -------------------------------------------------------------

    @property
    def n(self) -> int:
        return int(self.network.n)

    @property
    def partition(self):
        return self.network.partition

    @property
    def needs_deltas(self) -> bool:
        return bool(self.controller.needs_deltas)

    @property
    def rows(self) -> Tuple[PlanRow, ...]:
        return tuple(self._rows)

    # -- the control step ----------------------------------------------------

    def next_row(self, active: Optional[np.ndarray] = None
                 ) -> Tuple[PlanRow, Optional[dict]]:
        """Generate round ``t``'s row.  ``active`` (optional 0/1 mask,
        the streaming fault path) folds straggler renormalization into
        the row exactly like ``RoundPlan.with_active`` does per round.
        Returns ``(row, telemetry)``; telemetry is ``None`` unless the
        policy consumes realized connectivity (``needs_phi``)."""
        t, n, cfg = self._t, self.n, self.config
        if self._sparse:
            clusters = _sample_snapshot_sparse(self.network, self._rng, t)
            A: Union[np.ndarray, SparseA] = \
                network_matrix_sparse(clusters, n)
            d2d = sum(c.d2d_transmissions for c in clusters)
        else:
            clusters = _sample_snapshot(self.network, self._rng, t)
            A = np.asarray(network_matrix(clusters, n), np.float32)
            d2d = sum(count_d2d_transmissions(c.W) for c in clusters)

        # the open-loop planner's view of this draw (plan_rows verbatim)
        if cfg.bound_kind == "exact":
            psis = [exact_phi_ell(c.W) for c in clusters]
        else:
            psis = [phi_ell_bound_from_stats(c.stats, cfg.bound_kind)
                    for c in clusters]
        sizes = [c.size for c in clusters]
        m_rule = (self._m0 if t == 0
                  else sampling.min_clients(psis, sizes, n, cfg.phi_max))

        phis = None
        if self.controller.needs_phi:
            phis = tuple(
                exact_phi_ell_sparse(c) if self._sparse
                else exact_phi_ell(c.W) for c in clusters)

        realized = RealizedRound(
            t=t, n=n, sizes=tuple(int(s) for s in sizes),
            psis=tuple(float(p) for p in psis), phis=phis,
            m_rule=int(m_rule), phi_max=float(cfg.phi_max))
        decision = self.controller.observe(self._last_record, realized)

        m = min(max(int(decision.m), 1), n)
        psi_bound = float(psi_total(m, n, psis, sizes))
        vertex_sets = [c.vertices for c in clusters]
        tau, m_actual = sampling.sample_clients(self._rng, vertex_sets, m, n)
        eta = (float(cfg.eta(t)) if decision.eta is None
               else float(decision.eta))

        gossip = int(decision.tau)
        if gossip > 1 or decision.scheme == "sampled":
            A, d2d = self._realize_decision(A, clusters, tau, gossip,
                                            decision.scheme)
            self._pristine = False

        row = PlanRow(
            t=t, A=A, tau=np.asarray(tau, np.float32),
            m=float(m_actual), eta=eta, active=np.ones(n, np.float32),
            m_planned=int(m), m_actual=int(m_actual), d2s=int(m_actual),
            d2d=int(d2d), psi_bound=psi_bound)
        if active is not None:
            row = self._fold_active(row, active)

        telemetry = None
        if phis is not None:
            telemetry = {
                "m_rule": float(m_rule),
                "m_decided": float(m),
                "tau_gossip": float(gossip),
                "phi_realized_max": float(max(phis)),
                "psi_realized": float(psi_total(m, n, phis, sizes)),
            }

        self._rows.append(row)
        self._t += 1
        return row, telemetry

    def feed(self, record, deltas: Optional[np.ndarray] = None) -> None:
        """Post-round feedback: the executed round's ``RoundRecord``
        (shown to the policy as ``record_prev`` next round) and, when
        the policy declared ``needs_deltas``, the (n, P) client-delta
        matrix."""
        self._last_record = record
        if deltas is not None:
            self.controller.feed(record, deltas)

    # -- decision realization ------------------------------------------------

    def _realize_decision(self, A, clusters, tau_vec, gossip: int,
                          scheme: str):
        """Apply the non-trivial parts of a ``Decision`` to the mixing
        matrix: relay-scheme masking, then the cluster-blockwise
        ``gossip``-th power.  Never allocates anything larger than one
        (s, s) cluster block; the f64 power of the f32 single-step block
        is cast back to f32, so dense and sparse controlled runs realize
        identical values.  Returns ``(A', d2d')`` with ``d2d' = gossip x
        off-diagonal nonzeros of the masked single-step matrix`` (every
        iteration retransmits the same edges)."""
        n = self.n
        unsampled = np.asarray(tau_vec, np.float64) == 0.0
        is_sparse = isinstance(A, SparseA)
        if is_sparse:
            lut = np.zeros(n, dtype=np.int64)
            rows_g, cols_g = A.row_ids(), A.indices
            dsts: List[np.ndarray] = []
            srcs: List[np.ndarray] = []
            vals: List[np.ndarray] = []
        else:
            out = np.zeros((n, n), np.float32)
        d2d = 0
        for cg in clusters:
            verts = np.asarray(cg.vertices)
            s = len(verts)
            if is_sparse:
                lut[verts] = np.arange(s)
                # clusters are disjoint and A block-diagonal: entries
                # whose destination lies in this cluster are the block
                sel = np.isin(rows_g, verts)
                block = np.zeros((s, s), np.float64)
                block[lut[rows_g[sel]], lut[cols_g[sel]]] = A.data[sel]
            else:
                block = np.asarray(A[np.ix_(verts, verts)], np.float64)
            if scheme == "sampled":
                drop = np.flatnonzero(unsampled[verts])
                block[:, drop] = 0.0
                block[drop, drop] = 1.0
            d2d += gossip * int((block != 0.0).sum()
                                - (np.diagonal(block) != 0.0).sum())
            B = np.linalg.matrix_power(block, gossip).astype(np.float32)
            if is_sparse:
                bi, bj = np.nonzero(B)
                dsts.append(verts[bi])
                srcs.append(verts[bj])
                vals.append(B[bi, bj])
            else:
                out[np.ix_(verts, verts)] = B
        if is_sparse:
            return SparseA.from_edges(
                n, np.concatenate(dsts), np.concatenate(srcs),
                np.concatenate(vals)), d2d
        return out, d2d

    def _fold_active(self, row: PlanRow, active) -> PlanRow:
        """Per-row image of ``RoundPlan.with_active``: same dtypes, same
        reduction order, so a loop-folded row stacks into a plan that is
        bitwise-equal to ``emit_plan().with_active(...)`` of the
        unfolded run."""
        active = np.asarray(active, np.float32)
        if active.shape != row.tau.shape:
            raise ValueError(
                f"active must have shape {row.tau.shape}, got "
                f"{active.shape}")
        if not np.isin(active, (0.0, 1.0)).all():
            raise ValueError("active must be a 0/1 mask")
        eff = (row.tau * active).sum()
        if isinstance(row.A, SparseA):
            dropped = int(((row.A.data != 0.0)
                           & (active[row.A.indices] == 0.0)
                           & (row.A.row_ids() != row.A.indices)).sum())
        else:
            off = (np.asarray(row.A) != 0.0) \
                & ~np.eye(len(active), dtype=bool)
            dropped = int((off & (active == 0.0)[None, :]).sum())
        return dataclasses.replace(
            row, active=active,
            m=float(np.maximum(eff, np.float32(1.0)).astype(np.float64)),
            m_actual=int(eff), d2s=int(eff),
            d2d=max(int(row.d2d) - dropped, 0))

    # -- artifact ------------------------------------------------------------

    def emit_plan(self) -> RoundPlan:
        """Stack every generated row into the realized ``RoundPlan``.

        Always replayable; carries ``(topology, seed)`` regeneration
        provenance only when the loop owned a seeded rng AND the policy
        never altered what ``regenerate()`` would rebuild (no gossip
        powering / relay masking, no learned-graph feedback) --
        ``regenerate`` replays client sampling at the recorded
        ``m_planned_t``, so closed-loop *m* decisions alone do not
        forfeit regenerability.
        """
        if not self._rows:
            raise ValueError("emit_plan: no rounds generated yet")
        spec = getattr(self.network, "spec", None)
        spec = spec if isinstance(spec, TopologySpec) else None
        regenerable = (self._seeded and self._pristine
                       and not self._graph_fed)
        return RoundPlan.from_rows(
            self._rows, algorithm=self.algorithm, topology=spec,
            seed=int(self.config.seed) if regenerable else None)
