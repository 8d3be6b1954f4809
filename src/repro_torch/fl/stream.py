"""StreamEngine: staleness-aware semi-asynchronous aggregation (port of
``repro.fl.stream``).

The synchronous engine executes one plan round at a time: every sampled
client's delta lands before the eq.-4 update.  Real edge clients do not
cooperate -- they fail, stall, upload late, deliver twice, or leave.
``StreamEngine`` is the runtime beside ``LocalEngine``: clients train and
upload on their own clocks (virtual time, driven by a
``repro_torch.fl.faults.FaultTrace``), and the server closes round ``t``
when either ``b`` buffered uploads have landed (FedBuff, Nguyen et al.)
or a deadline expires -- whichever comes first.

Semi-async model (virtual time):

* round ``t`` dispatches at ``D_t = C_{t-1}`` (the previous closure):
  the current globals are snapshotted and every sampled-and-alive client
  starts local SGD; its upload lands at ``D_t + arrival_t[t, i]``.
* the server closes at ``C_t = min(b-th unconsumed arrival,
  D_t + deadline)`` and consumes *every* upload that has arrived, from
  any round not older than ``max_staleness``.
* an upload dispatched at round ``r`` and consumed at round ``t`` has
  staleness ``s = t - r`` and weight ``w(s)`` (``staleness_weight``:
  polynomial ``(1+s)^-a`` or exponential ``a^s`` discounting); the
  weights fold into the ``combine_weights`` row -- the same
  zero-payload-cost trick as the ``active_t`` mask, no kernel changes --
  and the eq.-4 divisor becomes the *weighted* upload count.

Graceful degradation, not crashes: a round with zero surviving uploads
skips the aggregate and carries params forward (``m_actual = 0``); a
deadline-cut round renormalizes to whatever arrived and records the
shortfall; over-stale uploads are discarded and counted.  Per-round
streaming telemetry rides in ``RoundRecord.stream`` (None for pristine
rounds, so a fault-free History is identical to the synchronous one).

Equivalences, locked by tests:

* full buffer (``buffer=None``), zero latency, no faults: every closure
  consumes exactly its own full cohort at weight 1.0, and the engine
  runs the *same* ``make_round_fn`` round as ``LocalEngine`` on the same
  plan-column tensors -- History and params reproduce the synchronous
  run bitwise.
* a zero-latency ``FaultTrace`` streamed here equals ``LocalEngine`` on
  ``plan.with_faults(trace)`` bitwise.
* any seeded ``FaultSpec`` trajectory replays bitwise from its JSON
  round-trip (all randomness is materialized host-side up front).

Port notes.  The engine runs on one device (``cuda`` unless given;
``fl.engine.resolve_device``) in full fp32 on the card
(``fl.engine.set_fp32_policy``).  The round and deltas functions are the
port's ``make_round_fn`` / ``client_deltas`` (``torch.func``), with no
``jit`` / ``chunk`` / ``interpret`` knobs.  The stale path launches the
``aggregate`` kernel once per contributing cohort
(``kernels.mixing.ops.aggregate_grouped`` with the cohort's staleness
weight) and divides by the weighted count ``W`` as an fp32 device tensor,
as the synchronous path divides by ``m``.  A cohort's ``snapshot`` is
the param tree round ``t`` trained from; stale rounds train against it
later, so nothing on this path writes a param tensor in place (local SGD,
the einsum epilogue and ``packing.apply_aggregate_row`` all build new
tensors).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.metrics import CommLedger
from repro_torch.core.pytree import tree_map
from repro_torch.core.rounds import client_deltas, make_round_fn
from repro_torch.core.server import History, RoundRecord
from repro_torch.kernels.mixing.ops import aggregate_grouped, combine_weights
from . import packing
from .engine import (_check_batches, _device_columns, _to_device,
                     resolve_backend, resolve_device, set_fp32_policy)
from .faults import FaultSpec, FaultTrace, sample_trace

__all__ = ["STALENESS_KINDS", "StreamConfig", "StreamEngine",
           "closure_time", "consume_arrivals", "staleness_weight"]

PyTree = Any

STALENESS_KINDS = ("none", "poly", "exp")


def staleness_weight(s: int, kind: str = "none",
                     param: float = 0.5) -> float:
    """Discount for an upload consumed ``s`` closures after dispatch.

    ``none``: always 1.0.  ``poly``: ``(1 + s) ** -param`` (FedBuff's
    polynomial discount).  ``exp``: ``param ** s``.  Every kind returns
    exactly 1.0 at ``s = 0``, which is what makes the synchronous path
    the bitwise-degenerate case (``x * 1.0 == x`` in IEEE arithmetic).
    """
    if kind not in STALENESS_KINDS:
        raise ValueError(
            f"staleness must be one of {STALENESS_KINDS}, got {kind!r}")
    if s == 0 or kind == "none":
        return 1.0
    if kind == "poly":
        return float((1.0 + s) ** (-param))
    return float(param ** s)


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """The semi-async server policy + the fault process driving it.

    ``buffer``        close after this many buffered uploads (FedBuff
                      ``b``); None = wait for the dispatching round's
                      own full cohort (synchronous-style closure).
    ``deadline``      max virtual time a round stays open after
                      dispatch; arrivals after it wait for a later
                      closure (and pick up staleness).
    ``staleness``     discount kind ('none' | 'poly' | 'exp') with
                      ``staleness_param`` (see ``staleness_weight``).
    ``max_staleness`` uploads older than this many closures are
                      discarded, not aggregated.
    ``faults``        optional ``FaultSpec``; with ``fault_seed`` it
                      fully determines the fault trajectory
                      (``sample_trace``), so runs replay bitwise.
    ``client_optim``  optional per-client local-optimizer assignment
                      (``repro_torch.optim.parse_client_optim`` syntax:
                      'sgd' | 'adam' | 'sgd,adam,...' round-robin).
                      Heterogeneous payloads are computed eagerly at
                      dispatch (optimizer state is sequential), so the
                      synchronous fast path never fires -- the pristine
                      run is NOT bitwise-equal to ``LocalEngine``, but
                      replay-from-recording still is.
    """
    buffer: Optional[int] = None
    deadline: float = math.inf
    staleness: str = "none"
    staleness_param: float = 0.5
    max_staleness: int = 16
    faults: Optional[FaultSpec] = None
    fault_seed: int = 0
    client_optim: Optional[str] = None

    def __post_init__(self):
        if self.buffer is not None and self.buffer < 1:
            raise ValueError(f"buffer must be >= 1, got {self.buffer}")
        if not self.deadline > 0:
            raise ValueError(f"deadline must be > 0, got {self.deadline}")
        if self.staleness not in STALENESS_KINDS:
            raise ValueError(f"staleness must be one of "
                             f"{STALENESS_KINDS}, got {self.staleness!r}")
        if self.max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {self.max_staleness}")
        if self.client_optim is not None:
            from repro_torch.optim import parse_client_optim
            parse_client_optim(self.client_optim, 1)   # names validate


@dataclasses.dataclass
class _Cohort:
    """One dispatched round still in flight: the params it trained from,
    its lazily-computed payload, and who has not been consumed yet."""
    t: int
    snapshot: PyTree
    pending: Dict[int, float]            # client -> absolute arrival time
    expected: Set[int]                   # everyone the plan said uploads
    payload: Any = None                  # packed bufs / delta tree (lazy)


def closure_time(cohorts: Dict[int, _Cohort], t: int, now: float,
                 S: StreamConfig) -> Tuple[float, bool]:
    """The FedBuff/deadline closure rule -- ONE scheduler body.

    ``C_t = min(target, now + deadline)`` where ``target`` is the b-th
    unconsumed arrival across cohorts (``buffer=b``) or round ``t``'s
    own last arrival (``buffer=None``).  Returns ``(C_t,
    deadline_hit)``.  Both the virtual-time ``StreamEngine`` and the
    wall-clock ``repro_torch.runtime`` ingestion engine call THIS
    function -- the wall runtime merely feeds it measured arrival
    positions (plus elapsed lower bounds for uploads still in flight),
    which is what makes live closure decisions and virtual-time replay
    the same arithmetic by construction rather than by tolerance.
    """
    if S.buffer is None:
        # synchronous-style: wait for round t's own full cohort
        waits = sorted(cohorts[t].pending.values())
    else:
        # FedBuff: wait until b unconsumed uploads (any round)
        # have landed; if fewer than b will ever arrive, wait
        # for all of them (the deadline still caps the wait)
        waits = sorted(a for c in cohorts.values()
                       for a in c.pending.values())[:S.buffer]
    target = max(waits[-1] if waits else now, now)
    C_t = min(target, now + S.deadline)
    return C_t, target > C_t


def consume_arrivals(cohorts: Dict[int, _Cohort], t: int, C_t: float,
                     S: StreamConfig
                     ) -> Tuple[List[Tuple[int, List[int], float]],
                                int, int, int]:
    """Consume every pending arrival ``<= C_t`` (shared with the
    wall-clock runtime, like ``closure_time``).  Returns
    ``(groups, late, stale_sum, stale_max)`` where ``groups`` is the
    per-cohort ``(r, client_idx, staleness_weight)`` list; consumed
    entries are removed from each cohort's ``pending``."""
    groups: List[Tuple[int, List[int], float]] = []
    late = stale_sum = stale_max = 0
    for r in sorted(cohorts):
        c = cohorts[r]
        idx = sorted(i for i, a in c.pending.items() if a <= C_t)
        if not idx:
            continue
        s = t - r
        w = staleness_weight(s, S.staleness, S.staleness_param)
        groups.append((r, idx, w))
        for i in idx:
            del c.pending[i]
        if s > 0:
            late += len(idx)
            stale_sum += s * len(idx)
            stale_max = max(stale_max, s)
    return groups, late, stale_sum, stale_max


def _stream_info(deadline_hit: bool, late: int, stale_sum: int,
                 stale_max: int, lost: int, dup_n: int, accepted: int,
                 W: float, m_actual: int) -> Optional[Dict[str, float]]:
    """A round's ``RoundRecord.stream`` telemetry (None when pristine)."""
    info: Dict[str, float] = {}
    if deadline_hit:
        info["deadline_hit"] = 1.0
    if late:
        info["late"] = float(late)
        info["stale_max"] = float(stale_max)
        info["stale_mean"] = stale_sum / late
    if lost:
        info["lost"] = float(lost)
    if dup_n:
        info["dup"] = float(dup_n)
    if accepted and W != accepted:
        info["m_weighted"] = float(W)
    if accepted < m_actual:
        info["shortfall"] = float(m_actual - accepted)
    return info or None


class StreamEngine:
    """Event-driven single-host runtime on one device.

    Dispatches each plan round at the previous closure, buffers uploads
    as they arrive in virtual time, and aggregates staleness-weighted
    cohort slices.  A closure that consumes exactly its own fresh, full
    cohort takes the *synchronous fast path* -- the round function
    ``LocalEngine`` runs -- so the no-fault case is bitwise-equal to the
    synchronous engine by construction, not by tolerance.

    After ``execute``: ``last_trace`` holds the sampled ``FaultTrace``
    (None without faults), ``last_realized_plan`` the plan actually run
    (faults folded into ``active_t``/``arrival_t`` -- a replayable
    artifact), ``last_closures`` the virtual closure times.
    """

    def __init__(self, loss_fn, cfg, device=None):
        if cfg.mesh is not None:
            raise ValueError("StreamEngine is single-host; cfg.mesh is "
                             "unsupported")
        if cfg.stream is None:
            raise ValueError("StreamEngine requires cfg.stream "
                             "(a StreamConfig)")
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.stream: StreamConfig = cfg.stream
        self.backend = resolve_backend(cfg)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_fp32_policy()
        self.last_trace: Optional[FaultTrace] = None
        self.last_realized_plan = None
        self.last_closures: List[float] = []
        self._spec = None        # packed-delta layout (set per execute)

    # -- trace / plan preparation ------------------------------------------

    def _apply_faults(self, plan):
        S = self.stream
        if S.faults is None:
            return plan, None
        partition = None
        if S.faults.failures == "cluster":
            if plan.topology is None:
                raise ValueError(
                    "failures='cluster' needs the plan's embedded "
                    "topology spec for the cluster partition; plan has "
                    "none")
            partition = plan.topology.build().partition
        trace = sample_trace(S.faults, n=plan.n_clients, K=plan.n_rounds,
                             seed=S.fault_seed, partition=partition)
        return plan.with_faults(trace), trace

    def _prepare(self, plan, params, batches):
        """Validate the plan and move its columns, the params and the
        batches to the engine's device (``fl.engine._device_columns``:
        the tensors ``LocalEngine`` builds from the same plan)."""
        _check_batches(plan, batches)
        if plan.quant is not None:
            raise ValueError(
                "quantized payloads are not supported on the stream "
                "runtime: stale cohorts re-aggregate deltas from earlier "
                "rounds, which has no well-defined error-feedback "
                "residual; strip with plan.with_quant(None) or run on "
                "LocalEngine")
        device = self.device
        # cohort closure slices dense A_t rows; sparse plans densify here
        # (the sparse *backends* are rejected by resolve_backend)
        cols = _device_columns(plan, device)
        params = _to_device(params, device)
        batches = [_to_device(b, device) for b in batches]
        return cols, params, batches

    # -- execution ----------------------------------------------------------

    def execute(self, plan, params, batches, *, eval_fn=None, eval_every=1,
                energy_ratio=0.1, trace=None):
        """Run the plan in virtual time.

        ``trace=`` replays a *recorded* trajectory: the plan is used
        as-is (already realized -- faults folded into ``active_t``, the
        ``arrival_t`` column carrying the recorded, possibly measured,
        offsets) and the injected ``FaultTrace`` supplies only the
        duplicate flags/delays for billing.  Requires
        ``cfg.stream.faults is None`` (nothing is sampled); this is how
        a ``repro_torch.runtime`` traffic recording reproduces its live
        run's History bitwise.
        """
        S = self.stream
        if trace is not None:
            if S.faults is not None:
                raise ValueError(
                    "trace= injects a recorded trajectory; the plan is "
                    "already realized, so cfg.stream.faults must be None")
        else:
            plan, trace = self._apply_faults(plan)
        (A_seq, tau_seq, m_seq, eta_seq, active_seq), params, batches = \
            self._prepare(plan, params, batches)
        self.last_trace = trace
        self.last_realized_plan = plan
        K, n = plan.n_rounds, plan.n_clients

        arrival = (np.asarray(plan.arrival_t, np.float64)
                   if plan.arrival_t is not None
                   else np.zeros((K, n), np.float64))

        # the synchronous fast path runs THIS function -- the one
        # LocalEngine's sequential loop runs, so a pristine closure is
        # bitwise-identical to the synchronous round
        round_fn = make_round_fn(self.loss_fn, self.backend)
        hetero = self._make_hetero(params, n)

        history = History(algorithm=plan.algorithm,
                          ledger=CommLedger(energy_ratio=energy_ratio))
        self._spec = None
        cohorts: Dict[int, _Cohort] = {}
        dup_events: List[float] = []    # pending duplicate arrival times
        closures: List[float] = []
        now = 0.0

        for t in range(K):
            # ---- dispatch round t at D_t = C_{t-1} -----------------------
            up_row = plan.tau_t[t] * plan.active_t[t]
            expected = {int(i) for i in np.flatnonzero(up_row > 0)}
            lost = 0
            pending: Dict[int, float] = {}
            for i in expected:
                delay = arrival[t, i]
                if math.isfinite(delay):
                    pending[i] = now + delay
                    if trace is not None and trace.dup[t, i] > 0:
                        dup_events.append(now + delay
                                          + float(trace.dup_delay[t, i]))
                else:       # plan says "uploads" but the delay is inf
                    lost += 1
            cohorts[t] = _Cohort(t=t, snapshot=params, pending=pending,
                                 expected=expected)
            if hetero is not None:
                # eager, dispatch-order payload: per-client optimizer
                # state is sequential, so the evaluation order must be
                # the dispatch order on both the live and replay sides
                cohorts[t].payload = self._cohort_payload(
                    hetero, params, batches[t], eta_seq[t])

            # ---- evict over-stale cohorts (their uploads are dead) -------
            for r in [r for r in cohorts if t - r > S.max_staleness]:
                lost += len(cohorts[r].pending)
                del cohorts[r]

            # ---- closure time C_t + consume every arrival <= C_t ---------
            C_t, deadline_hit = closure_time(cohorts, t, now, S)
            groups, late, stale_sum, stale_max = consume_arrivals(
                cohorts, t, C_t, S)
            accepted = sum(len(idx) for _, idx, _ in groups)
            W = sum(w * len(idx) for _, idx, w in groups)
            dup_n = sum(1 for a in dup_events if a <= C_t)
            dup_events = [a for a in dup_events if a > C_t]

            # ---- aggregate (graceful: zero survivors -> carry forward) ---
            if accepted == 0:
                pass                     # params unchanged, m_actual = 0
            elif self._is_sync_closure(groups, cohorts, t):
                active = active_seq[t] if active_seq is not None else None
                params = round_fn(params, batches[t], A_seq[t],
                                  tau_seq[t], m_seq[t], eta_seq[t],
                                  active)[0]
            else:
                params = self._aggregate_groups(
                    params, groups, cohorts, batches, A_seq, tau_seq,
                    eta_seq, active_seq, W, n)

            for r in [r for r, c in cohorts.items() if not c.pending]:
                del cohorts[r]

            # ---- record --------------------------------------------------
            rec = RoundRecord(
                t=plan.t0 + t, m=int(plan.m_planned_t[t]),
                m_actual=accepted,
                psi_bound=float(plan.psi_bound_t[t]),
                d2s=accepted + dup_n, d2d=int(plan.d2d_t[t]),
                eta=float(plan.eta_t[t]))
            if eval_fn is not None and (t % eval_every == 0 or t == K - 1):
                rec.metrics = {k: float(v)
                               for k, v in eval_fn(params).items()}
            rec.stream = _stream_info(deadline_hit, late, stale_sum,
                                      stale_max, lost, dup_n, accepted, W,
                                      int(plan.m_actual_t[t]))
            history.records.append(rec)
            history.ledger.add_round(d2s=rec.d2s, d2d=rec.d2d)
            closures.append(C_t)
            now = C_t

        self.last_closures = closures
        return params, history

    def execute_controlled(self, loop, params, batches, *, eval_fn=None,
                           eval_every=1, energy_ratio=0.1):
        """Closed-loop semi-async execution: a ``repro_torch.control``
        ``ControlLoop`` generates each round's row online (the policy
        observing realized connectivity AND the previous round's
        streaming telemetry), while the fault trace drives the same
        virtual-time closure rule as ``execute``.

        The fault trajectory is materialized up front (``sample_trace``
        is host-side and seeded), and each round's availability mask is
        folded into the row before dispatch -- so
        ``self.last_realized_plan`` (the emitted plan + the trace's
        arrival column) replayed through a fault-free ``StreamEngine``
        with the same closure policy reproduces this run's params
        bitwise, exactly like the ``execute`` replay discipline.
        Controllers needing delta feedback are rejected: a stale closure
        mixes cohorts from several rounds, so "the round's (n, P) delta
        matrix" is not well defined here.
        """
        S = self.stream
        if loop.needs_deltas:
            raise ValueError(
                "delta-feedback controllers (needs_deltas) are not "
                "supported on the stream runtime: stale closures mix "
                "cohorts from several rounds; use LocalEngine")
        if bool(getattr(loop, "_sparse")):
            raise ValueError(
                "the stream runtime slices dense A_t rows; build the "
                "ControlLoop with sparse=False")
        if S.client_optim is not None:
            raise ValueError(
                "client_optim is not supported under controlled "
                "execution: the realized plan carries no optimizer "
                "state to replay heterogeneous payloads against; run "
                "execute() with a precomputed plan instead")
        K, n = len(batches), loop.n
        device = self.device
        trace = None
        if S.faults is not None:
            partition = (loop.partition
                         if S.faults.failures == "cluster" else None)
            trace = sample_trace(S.faults, n=n, K=K, seed=S.fault_seed,
                                 partition=partition)
        self.last_trace = trace
        arrival = (np.asarray(trace.arrival, np.float64)
                   if trace is not None else np.zeros((K, n), np.float64))
        use_active = trace is not None and bool((trace.active != 1.0).any())

        round_fn = make_round_fn(self.loss_fn, self.backend)
        params = _to_device(params, device)
        batches = [_to_device(b, device) for b in batches]

        def col(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=device)

        history = History(algorithm=loop.algorithm,
                          ledger=CommLedger(energy_ratio=energy_ratio))
        self._spec = None
        cohorts: Dict[int, _Cohort] = {}
        dup_events: List[float] = []
        closures: List[float] = []
        # per-round device columns, grown as rows materialize (the stale
        # path indexes them by cohort round r < t, always already built)
        A_seq: List[torch.Tensor] = []
        tau_seq: List[torch.Tensor] = []
        eta_seq: List[torch.Tensor] = []
        active_seq: Optional[List[torch.Tensor]] = [] if use_active else None
        now = 0.0

        for t in range(K):
            row, telemetry = loop.next_row(
                active=trace.active[t] if trace is not None else None)
            A_seq.append(col(row.A))
            tau_seq.append(col(row.tau))
            eta_seq.append(col(row.eta))
            if active_seq is not None:
                active_seq.append(col(row.active))

            # ---- dispatch round t at D_t = C_{t-1} -----------------------
            up_row = row.tau * row.active
            expected = {int(i) for i in np.flatnonzero(up_row > 0)}
            lost = 0
            pending: Dict[int, float] = {}
            for i in expected:
                delay = arrival[t, i]
                if math.isfinite(delay):
                    pending[i] = now + delay
                    if trace is not None and trace.dup[t, i] > 0:
                        dup_events.append(now + delay
                                          + float(trace.dup_delay[t, i]))
                else:
                    lost += 1
            cohorts[t] = _Cohort(t=t, snapshot=params, pending=pending,
                                 expected=expected)

            for r in [r for r in cohorts if t - r > S.max_staleness]:
                lost += len(cohorts[r].pending)
                del cohorts[r]

            C_t, deadline_hit = closure_time(cohorts, t, now, S)
            groups, late, stale_sum, stale_max = consume_arrivals(
                cohorts, t, C_t, S)
            accepted = sum(len(idx) for _, idx, _ in groups)
            W = sum(w * len(idx) for _, idx, w in groups)
            dup_n = sum(1 for a in dup_events if a <= C_t)
            dup_events = [a for a in dup_events if a > C_t]

            if accepted == 0:
                pass
            elif self._is_sync_closure(groups, cohorts, t):
                active = active_seq[t] if active_seq is not None else None
                params = round_fn(params, batches[t], A_seq[t],
                                  tau_seq[t], col(row.m), eta_seq[t],
                                  active)[0]
            else:
                params = self._aggregate_groups(
                    params, groups, cohorts, batches, A_seq, tau_seq,
                    eta_seq, active_seq, W, n)

            for r in [r for r, c in cohorts.items() if not c.pending]:
                del cohorts[r]

            rec = RoundRecord(
                t=row.t, m=row.m_planned, m_actual=accepted,
                psi_bound=row.psi_bound, d2s=accepted + dup_n,
                d2d=row.d2d, eta=row.eta, control=telemetry)
            if eval_fn is not None and (t % eval_every == 0 or t == K - 1):
                rec.metrics = {k: float(v)
                               for k, v in eval_fn(params).items()}
            rec.stream = _stream_info(deadline_hit, late, stale_sum,
                                      stale_max, lost, dup_n, accepted, W,
                                      row.m_actual)
            history.records.append(rec)
            history.ledger.add_round(d2s=rec.d2s, d2d=rec.d2d)
            closures.append(C_t)
            now = C_t
            loop.feed(rec)

        realized = loop.emit_plan()
        if trace is not None:
            realized = realized.with_arrivals(trace.arrival)
        self.last_realized_plan = realized
        self.last_closures = closures
        return params, history

    # -- internals ----------------------------------------------------------

    @staticmethod
    def _pristine(groups, cohorts, t) -> bool:
        """True iff this closure consumed exactly round ``t``'s own full
        expected cohort at weight 1.0 -- the *shape* of a synchronous
        round, independent of whether a payload was precomputed."""
        if len(groups) != 1:
            return False
        r, idx, w = groups[0]
        c = cohorts.get(t)
        return (r == t and w == 1.0 and c is not None
                and set(idx) == c.expected)

    @staticmethod
    def _is_sync_closure(groups, cohorts, t) -> bool:
        """True iff this closure is a pristine synchronous round whose
        payload was never computed -- then the globals it trained from
        ARE the current globals and the synchronous round function
        applies verbatim.  (A pristine closure with an eagerly computed
        payload -- heterogeneous optimizers -- must take the aggregate
        path: the payload is not plain-SGD deltas.)"""
        return (StreamEngine._pristine(groups, cohorts, t)
                and cohorts[t].payload is None)

    def _make_hetero(self, params, n):
        """Build the heterogeneous local-training runner (or None).
        One per execute(): per-client optimizer state starts fresh at
        round 0 on both the live and replay sides."""
        if self.stream.client_optim is None:
            return None
        from repro_torch.optim import (HeteroClientOptimizers,
                                       parse_client_optim)
        names = parse_client_optim(self.stream.client_optim, n)
        return HeteroClientOptimizers(self.loss_fn, params, names,
                                      device=self.device)

    def _pack(self, d):
        """A delta tree as the backend's payload: the tree itself on
        'einsum', else its packed per-dtype group buffers (one layout for
        the whole run: the param tree is fixed)."""
        if self.backend == "einsum":
            return d
        if self._spec is None:
            self._spec = packing.pack_spec(d)
        return packing.pack(d, self._spec)

    def _cohort_payload(self, hetero, snapshot, batch, eta):
        """Eager dispatch-time payload: the heterogeneous delta tree for
        ALL n clients (every client's optimizer state advances whether
        or not its upload is later consumed), packed per backend exactly
        like the lazy path."""
        return self._pack(hetero.deltas(snapshot, batch, eta))

    def _aggregate_groups(self, params, groups, cohorts, batches, A_seq,
                          tau_seq, eta_seq, active_seq, W, n):
        """The stale path: one combine-row aggregation per contributing
        cohort, each against the params that cohort trained from, every
        row divided by the shared weighted count ``W``, summed, and
        applied to the globals in one epilogue."""
        device = self.device
        Wj = torch.tensor(W, dtype=torch.float32, device=device)
        acc_rows = None                  # kernel path: per-group fp32 rows
        acc_tree = None                  # einsum path: fp32 delta tree
        for r, idx, w in groups:
            c = cohorts[r]
            if c.payload is None:
                c.payload = self._pack(client_deltas(
                    self.loss_fn, c.snapshot, batches[r], eta_seq[r]))
            u = np.zeros(n, np.float32)
            u[idx] = 1.0
            tau_u = tau_seq[r] * torch.as_tensor(u, device=device)
            act_r = active_seq[r] if active_seq is not None else None
            wj = torch.tensor(w, dtype=torch.float32, device=device)
            if self.backend == "einsum":
                row = combine_weights(A_seq[r], tau_u, Wj, act_r, wj)
                contrib = tree_map(
                    lambda dd: torch.einsum("i,i...->...", row, dd.float()),
                    c.payload)
                acc_tree = contrib if acc_tree is None else tree_map(
                    torch.add, acc_tree, contrib)
            else:
                rows = aggregate_grouped(A_seq[r], tau_u, Wj, c.payload,
                                         active=act_r, weights=wj)
                acc_rows = rows if acc_rows is None else tuple(
                    a + b for a, b in zip(acc_rows, rows))
        if self.backend == "einsum":
            return tree_map(lambda g, a: (g + a).to(g.dtype), params,
                            acc_tree)
        return packing.apply_aggregate_row(params, acc_rows, self._spec)
