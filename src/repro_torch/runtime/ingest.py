"""IngestEngine: the wall-clock ingestion runtime (port of
``repro.runtime.ingest``).

``StreamEngine`` *simulates* semi-async rounds in virtual time;
``IngestEngine`` *runs* them: simulated clients train on worker threads
against snapshot params and upload through a bounded queue with real
(scaled) latency, while the server loop ingests arrivals and closes
rounds FedBuff-style.  It subclasses ``StreamEngine`` and reuses its
fault sampling, payload packing, staleness-weighted aggregation, and
telemetry verbatim -- only the *source of arrival positions* changes,
through the ``repro_torch.runtime.clock`` abstraction.

The guarded commit (how live closure == replay closure, bitwise)
----------------------------------------------------------------
Every landed upload gets a measured float32 offset
``(wall_land - wall_dispatch) / time_scale``; its virtual position is
``D_r + offset`` -- exactly the number a replay reads from the recorded
``arrival_t`` column.  For uploads still in flight the server only
knows a *lower bound*: the elapsed time since their cohort's dispatch
(float32 round-to-nearest is monotone, so the eventual measured offset
cannot round below a bound taken earlier).  The loop inserts those
lower bounds into the pending view, evaluates the shared
``closure_time`` rule, and COMMITS only when every in-flight bound is
strictly beyond the candidate ``C_t`` -- then no upload that has not
landed could have changed the decision, so the virtual-time replay
(which knows all positions up front) computes the identical ``C_t``,
consumption set, and staleness weights.  Otherwise the loop sleeps
until the queue stirs and retries.

Overlapping dispatch
--------------------
``overlap=True`` computes each cohort's payload on a worker at dispatch
(upload timers start at payload-ready), so round ``t+1`` trains while
round ``t``'s stragglers drain; ``overlap=False`` computes payloads
lazily at closure on the server thread (the serialized baseline).  A
pristine closure discards any precomputed payload and runs the
synchronous round function -- the same fast path the replay side
takes, keeping the anchor bitwise.  Heterogeneous optimizers
(``client_optim``) always train eagerly on a dedicated ordered worker:
per-client optimizer state is sequential, so payloads must evaluate in
dispatch order.

Known, documented divergence: backpressure drops.  A dropped upload is
billed ``lost`` in the live round whose gather observed the drop, but
its recorded arrival stays ``inf`` so a replay counts it lost at its
dispatch round.  Totals agree; per-round attribution differs.  The
anchor tests run with drop-free capacities.

Port notes (what JAX's arrays did implicitly and CUDA does not):

* *Payload-ready means computed.*  A CUDA launch returns before its work
  runs, so a worker's job ends with a barrier on the stream the payload
  was made on (an event recorded after the payload, then
  ``event.synchronize()``); otherwise the future would resolve at
  enqueue time, the upload timers would start before any FLOP ran, and
  the training cost would move into the consuming round's aggregate.
  Workers and server share the device's current stream, so the server
  reads a payload after its producer's kernels in stream order and no
  buffer crosses streams.  ``last_payload_ready`` records, per
  overlapped cohort, whether that event had completed when the future
  resolved (None on the CPU).
* *Warm before the clock starts.*  ``_warmup`` runs every path the live
  loop can hit (the pristine round, the packed payload, the stale
  aggregation, the heterogeneous runners) and waits for the device, so
  no kernel build (``kernels/_build.py``) or library handle creation is
  timed as upload latency; ``WallClock.prime`` then runs the payload
  once on every training thread (library handles are per thread).
* *A failed worker does not vanish.*  Every training future is watched:
  one that ended in an exception -- consumed, discarded by a pristine
  closure, or evicted -- re-raises it on the server thread after the
  round that sees it done, and after the final flush.  The clock's
  ``finish`` runs whatever happens and joins every thread.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.metrics import CommLedger
from repro_torch.core.rounds import client_deltas, make_round_fn
from repro_torch.core.server import History, RoundRecord
from repro_torch.fl.stream import (StreamEngine, _Cohort, _stream_info,
                                   closure_time, consume_arrivals)
from .clock import Clock, VirtualClock, WallClock
from .queueing import DROP_POLICIES
from .recorder import (Recording, TrafficRecorder, history_digest,
                       params_sha256)

__all__ = ["CLOCK_KINDS", "IngestEngine", "RuntimeConfig"]

CLOCK_KINDS = ("virtual", "wall")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """The ingestion-runtime knobs (``ExecutionConfig.runtime``).

    ``clock``           'wall' runs real threads and measures arrivals;
                        'virtual' degenerates to ``StreamEngine``
                        semantics bitwise (arrivals from the plan).
    ``time_scale``      wall seconds per virtual time unit -- latency
                        distributions in ``FaultSpec`` stay in virtual
                        units, tests shrink this to keep wall time low.
    ``workers``         training worker threads (the client fleet).
    ``overlap``         dispatch-ahead (see module docstring).
    ``queue_capacity``  bound on the upload queue (None = unbounded).
    ``drop_policy``     'block' | 'drop_oldest' | 'reject' at capacity.
    ``wall_budget``     graceful stop after this many wall seconds: the
                        current round still closes, the recorder
                        flushes, and the sliced recording replays.
    """
    clock: str = "wall"
    time_scale: float = 0.01
    workers: int = 4
    overlap: bool = True
    queue_capacity: Optional[int] = None
    drop_policy: str = "block"
    wall_budget: Optional[float] = None

    def __post_init__(self):
        if self.clock not in CLOCK_KINDS:
            raise ValueError(
                f"clock must be one of {CLOCK_KINDS}, got {self.clock!r}")
        if not self.time_scale > 0:
            raise ValueError(
                f"time_scale must be > 0, got {self.time_scale}")
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.queue_capacity is not None and self.queue_capacity < 1:
            raise ValueError(f"queue_capacity must be >= 1, got "
                             f"{self.queue_capacity}")
        if self.drop_policy not in DROP_POLICIES:
            raise ValueError(f"drop_policy must be one of "
                             f"{DROP_POLICIES}, got {self.drop_policy!r}")
        if self.wall_budget is not None and not self.wall_budget > 0:
            raise ValueError(
                f"wall_budget must be > 0, got {self.wall_budget}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _payload_barrier(device: torch.device) -> Optional[torch.cuda.Event]:
    """Wait until the work enqueued so far on ``device``'s current stream
    has run; returns the event waited on (None on the CPU)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    event.synchronize()
    return event


def _raise_failed(watched: List[Future], final: bool = False) -> None:
    """Re-raise the first exception among the finished training futures
    (all of them when ``final``: the pool has joined) and stop watching
    the finished ones."""
    done = [f for f in watched if final or f.done()]
    for f in done:
        watched.remove(f)
    for f in done:
        if not f.cancelled() and f.exception() is not None:
            raise f.exception()


class IngestEngine(StreamEngine):
    """Wall-clock ingestion runtime (see module docstring).

    After ``execute``: ``last_recording`` holds the flushed
    ``Recording`` (measured plan + trace + closures + run meta);
    ``last_realized_plan`` is that recording's plan;
    ``last_payload_ready`` maps each overlapped cohort to whether its
    payload's CUDA event had completed when its future resolved.
    """

    def __init__(self, loss_fn, cfg, device=None):
        super().__init__(loss_fn, cfg, device=device)
        if cfg.runtime is None:
            raise ValueError("IngestEngine requires cfg.runtime "
                             "(a RuntimeConfig)")
        self.runtime: RuntimeConfig = cfg.runtime
        self.last_recording: Optional[Recording] = None
        self.last_payload_ready: Dict[int, Optional[bool]] = {}
        self._stop = threading.Event()

    def request_stop(self) -> None:
        """Ask the server loop (from any thread / signal handler) to
        stop after the round currently closing; the recorder flushes a
        loadable, replayable prefix recording."""
        self._stop.set()

    def execute_controlled(self, *a, **kw):
        raise ValueError(
            "controlled execution is not supported on the ingestion "
            "runtime: the control loop generates rows online, but the "
            "wall runtime needs the full plan to schedule uploads; run "
            "the controller on StreamEngine and ingest its emitted plan")

    def execute(self, plan, params, batches, *, eval_fn=None, eval_every=1,
                energy_ratio=0.1, trace=None):
        if trace is not None:
            raise ValueError(
                "trace= replay goes through the virtual-time "
                "StreamEngine (Recording.replay), not the ingestion "
                "runtime")
        S, R = self.stream, self.runtime
        plan, fault_trace = self._apply_faults(plan)
        (A_seq, tau_seq, m_seq, eta_seq, active_seq), params, batches = \
            self._prepare(plan, params, batches)
        self.last_trace = fault_trace
        K, n = plan.n_rounds, plan.n_clients
        arrival = (np.asarray(plan.arrival_t, np.float64)
                   if plan.arrival_t is not None
                   else np.zeros((K, n), np.float64))

        round_fn = make_round_fn(self.loss_fn, self.backend)
        hetero = self._make_hetero(params, n)

        wall = R.clock == "wall"
        # the packed layout is set by the first payload -- the warm-up's
        # on the wall clock, so no two workers race to set it
        self._spec = None
        if wall:
            # build and run every path before the clock starts: a cold
            # kernel build outlives many deadline windows, which would
            # record every round-0 upload many virtual units late
            self._warmup(round_fn, hetero, params, batches, A_seq,
                         tau_seq, m_seq, eta_seq, active_seq, n)
        clock: Clock = (WallClock(R.time_scale, workers=R.workers,
                                  queue_capacity=R.queue_capacity,
                                  drop_policy=R.drop_policy)
                        if wall else VirtualClock())
        rec = TrafficRecorder(K, n)
        history = History(algorithm=plan.algorithm,
                          ledger=CommLedger(energy_ratio=energy_ratio))
        self._stop.clear()
        self.last_payload_ready = {}
        cohorts: Dict[int, _Cohort] = {}
        inflight: Dict[int, Set[int]] = {}     # live cohorts' un-landed
        orphans: Set[Tuple[int, int]] = set()  # evicted cohorts' un-landed
        futures: Dict[int, Future] = {}        # cohort -> payload future
        watched: List[Future] = []             # every future not yet checked
        D_virt: Dict[int, float] = {}
        dup_events: List[float] = []
        closures: List[float] = []
        drops_now = [0]                        # drops seen this gather
        now = 0.0

        def drain_landings():
            landed, dropped = clock.drain()
            for u in landed:
                off = clock.offset(u.round, u.wall)
                rec.land(u.round, u.client, off)
                pos = D_virt[u.round] + float(off)
                if u.client in inflight.get(u.round, ()):
                    cohorts[u.round].pending[u.client] = pos
                    inflight[u.round].discard(u.client)
                else:
                    orphans.discard((u.round, u.client))
                if (fault_trace is not None
                        and fault_trace.dup[u.round, u.client] > 0):
                    dup_events.append(pos + float(
                        fault_trace.dup_delay[u.round, u.client]))
            for u in dropped:
                rec.drop(u.round, u.client)
                if u.client in inflight.get(u.round, ()):
                    inflight[u.round].discard(u.client)
                    drops_now[0] += 1    # billed in the observing round
                else:
                    # orphan drop: already billed lost at eviction
                    orphans.discard((u.round, u.client))

        def gather(t):
            """The guarded commit: drain, bound, decide, retry."""
            while True:
                drain_landings()
                lowers: Dict[int, float] = {}
                for r, fl in inflight.items():
                    if not fl:
                        continue
                    lo = D_virt[r] + float(clock.lower_offset(r))
                    lowers[r] = lo
                    for i in fl:
                        cohorts[r].pending[i] = lo
                C_t, deadline_hit = closure_time(cohorts, t, now, S)
                for r in lowers:
                    for i in inflight[r]:
                        del cohorts[r].pending[i]
                if all(lo > C_t for lo in lowers.values()):
                    return C_t, deadline_hit
                gap = min(C_t - lo for lo in lowers.values()
                          if lo <= C_t)
                clock.wait(max(1e-3, gap * R.time_scale))

        try:
            if wall and (hetero is not None or R.overlap):
                snap0, b0, e0 = params, batches[0], eta_seq[0]
                clock.prime(lambda: self._train_job(self._packed_payload,
                                                    snap0, b0, e0))
            for t in range(K):
                if t > 0 and (self._stop.is_set()
                              or (R.wall_budget is not None
                                  and clock.elapsed() >= R.wall_budget)):
                    break
                # ---- dispatch round t at D_t = C_{t-1} -------------------
                up_row = plan.tau_t[t] * plan.active_t[t]
                expected = {int(i) for i in np.flatnonzero(up_row > 0)}
                lost = 0
                pending: Dict[int, float] = {}
                D_virt[t] = now
                if wall:
                    sched = []
                    for i in expected:
                        delay = arrival[t, i]
                        if math.isfinite(delay):
                            sched.append((i, float(delay)))
                        else:
                            lost += 1
                    train_fn = None
                    ordered = False
                    snap, bt, et = params, batches[t], eta_seq[t]
                    if hetero is not None:
                        # ordered eager payload: optimizer state is
                        # sequential, evaluation order = dispatch order
                        train_fn = (lambda s=snap, b=bt, e=et:
                                    self._train_job(
                                        self._cohort_payload, hetero, s,
                                        b, e))
                        ordered = True
                    elif R.overlap:
                        train_fn = (lambda s=snap, b=bt, e=et:
                                    self._train_job(self._packed_payload,
                                                    s, b, e))
                    fut = clock.dispatch(t, sched, train_fn=train_fn,
                                         ordered=ordered)
                    if fut is not None:
                        futures[t] = fut
                        watched.append(fut)
                        fut.add_done_callback(
                            lambda f, r=t: self._note_ready(r, f))
                    inflight[t] = {i for i, _ in sched}
                else:
                    for i in expected:
                        delay = arrival[t, i]
                        if math.isfinite(delay):
                            pending[i] = now + delay
                            rec.land(t, i, np.float32(delay))
                            if (fault_trace is not None
                                    and fault_trace.dup[t, i] > 0):
                                dup_events.append(now + delay + float(
                                    fault_trace.dup_delay[t, i]))
                        else:
                            lost += 1
                cohorts[t] = _Cohort(t=t, snapshot=params, pending=pending,
                                     expected=expected)
                if hetero is not None and not wall:
                    cohorts[t].payload = self._cohort_payload(
                        hetero, params, batches[t], eta_seq[t])

                # ---- evict over-stale cohorts ----------------------------
                for r in [r for r in cohorts if t - r > S.max_staleness]:
                    gone = inflight.pop(r, set())
                    lost += len(cohorts[r].pending) + len(gone)
                    orphans.update((r, i) for i in gone)
                    del cohorts[r]
                    futures.pop(r, None)

                # ---- guarded closure + consume ---------------------------
                drops_now[0] = 0
                C_t, deadline_hit = gather(t)
                groups, late, stale_sum, stale_max = consume_arrivals(
                    cohorts, t, C_t, S)
                lost += drops_now[0]
                accepted = sum(len(idx) for _, idx, _ in groups)
                W = sum(w * len(idx) for _, idx, w in groups)
                dup_n = sum(1 for a in dup_events if a <= C_t)
                dup_events = [a for a in dup_events if a > C_t]

                # ---- aggregate -------------------------------------------
                if accepted == 0:
                    pass
                elif (self._pristine(groups, cohorts, t)
                      and hetero is None):
                    # pristine closure: run the synchronous round
                    # function and DISCARD any precomputed payload -- the
                    # replay side (payload never computed) takes the same
                    # fast path, keeping the anchor bitwise
                    active = (active_seq[t] if active_seq is not None
                              else None)
                    params, _ = round_fn(params, batches[t], A_seq[t],
                                         tau_seq[t], m_seq[t], eta_seq[t],
                                         active)
                else:
                    for r, _, _ in groups:
                        fut = futures.get(r)
                        if fut is not None and cohorts[r].payload is None:
                            cohorts[r].payload = fut.result()[0]
                    params = self._aggregate_groups(
                        params, groups, cohorts, batches, A_seq, tau_seq,
                        eta_seq, active_seq, W, n)

                for r in [r for r, c in cohorts.items()
                          if not c.pending and not inflight.get(r)]:
                    del cohorts[r]
                    inflight.pop(r, None)
                    futures.pop(r, None)
                _raise_failed(watched)

                # ---- record ----------------------------------------------
                rr = RoundRecord(
                    t=plan.t0 + t, m=int(plan.m_planned_t[t]),
                    m_actual=accepted,
                    psi_bound=float(plan.psi_bound_t[t]),
                    d2s=accepted + dup_n, d2d=int(plan.d2d_t[t]),
                    eta=float(plan.eta_t[t]))
                if eval_fn is not None and (t % eval_every == 0
                                            or t == K - 1):
                    rr.metrics = {k: float(v)
                                  for k, v in eval_fn(params).items()}
                rr.stream = _stream_info(deadline_hit, late, stale_sum,
                                         stale_max, lost, dup_n, accepted,
                                         W, int(plan.m_actual_t[t]))
                history.records.append(rr)
                history.ledger.add_round(d2s=rr.d2s, d2d=rr.d2d)
                rec.close_round(C_t)
                closures.append(C_t)
                now = C_t
        finally:
            # ---- graceful finish: flush every in-flight upload -----------
            # timers wake early and enqueue forced landings; their
            # measured offsets exceed the last committed C_t (the guard
            # held), so the replay leaves them pending like the live run
            clock.finish()
        drain_landings()
        _raise_failed(watched, final=True)

        meta = {
            "clock": R.clock, "time_scale": R.time_scale,
            "overlap": R.overlap, "workers": R.workers,
            "queue_capacity": R.queue_capacity,
            "drop_policy": R.drop_policy,
            "wall_seconds": clock.elapsed(),
            "history": history_digest(history),
            "params_sha256": params_sha256(params),
        }
        recording = rec.finalize(plan, S, fault_trace, meta)
        self.last_recording = recording
        self.last_realized_plan = recording.plan
        self.last_closures = closures
        return params, history

    def _train_job(self, payload_fn, *args) -> Tuple[Any, Any]:
        """A worker's job: the payload, then the barrier that makes its
        future resolve only once the payload is computed."""
        payload = payload_fn(*args)
        return payload, _payload_barrier(self.device)

    def _note_ready(self, t: int, fut: Future) -> None:
        """Done-callback of cohort ``t``'s payload future (it runs as the
        future resolves): was the payload's event complete then?"""
        if fut.cancelled() or fut.exception() is not None:
            return
        event = fut.result()[1]
        self.last_payload_ready[t] = (None if event is None
                                      else bool(event.query()))

    def _warmup(self, round_fn, hetero, params, batches, A_seq, tau_seq,
                m_seq, eta_seq, active_seq, n):
        """Build and run every path the live loop can hit, against the
        real round-0 shapes, before wall time starts counting, waiting
        for the device after each.  All calls are pure (heterogeneous
        state is NOT advanced) and their results are discarded."""
        active = active_seq[0] if active_seq is not None else None
        round_fn(params, batches[0], A_seq[0], tau_seq[0], m_seq[0],
                 eta_seq[0], active)
        _sync(self.device)
        payload = self._packed_payload(params, batches[0], eta_seq[0])
        _sync(self.device)
        if hetero is not None:
            hetero.warmup(params, batches[0], eta_seq[0])
        # the stale aggregation path (combine rows over a packed
        # payload) against a synthetic single group
        cohort = _Cohort(t=0, snapshot=params, pending={},
                         expected=set(), payload=payload)
        self._aggregate_groups(
            params, [(0, list(range(n)), 0.5)], {0: cohort}, batches,
            A_seq, tau_seq, eta_seq, active_seq, 0.5 * n, n)
        _sync(self.device)

    def _packed_payload(self, snapshot, batch, eta):
        """Overlapped-dispatch payload: plain-SGD cohort deltas packed
        exactly like the lazy at-closure path in ``_aggregate_groups``
        (same functions, same inputs -> bitwise-equal buffers)."""
        return self._pack(client_deltas(self.loss_fn, snapshot, batch, eta))
