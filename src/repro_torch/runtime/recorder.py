"""TrafficRecorder: every live ingestion run becomes a replayable artifact
(port of ``repro.runtime.recorder``; the JSON format is the reference's,
so a recording made by either package loads in the other).

A wall-clock run's outcome depends on thread scheduling, kernel builds,
and host load -- none of which can be rerun.  What CAN be rerun is the
*decision-relevant* trace the run measured: which uploads landed, at
what float32 virtual-time offset after their cohort's dispatch, which
were duplicated, and where the server closed each round.  The recorder
accumulates exactly that and packages it as a ``Recording``:

* the realized ``RoundPlan`` with ``arrival_t`` := the measured offsets
  (``inf`` where an upload never landed or was dropped by backpressure),
* the semi-async server policy (``StreamConfig`` fields minus the
  generative ``faults`` spec -- the recording IS the realization),
* the live ``FaultTrace`` (duplicate flags/delays for billing; None for
  fault-free runs),
* the closure times and a run-meta block (History digest, params
  sha256, drop itemization, wall stats).

``Recording.replay`` pushes the artifact through the *virtual-time*
``StreamEngine`` -- the live run's ``History`` and final params
reproduce bitwise (asserted by ``verify``), which is the subsystem's
correctness anchor: wall-clock ingestion is just another way of
producing the same closure arithmetic the simulator executes.

``params_sha256`` hashes the leaves in ``jax.tree.leaves`` order (the
port's ``tree_leaves``: dict keys sorted), each leaf's raw bytes read
on the host; a bf16 leaf is hashed as its int16 bit pattern.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pytree import tree_leaves
from repro_torch.fl.faults import FaultTrace
from repro_torch.fl.plan import RoundPlan

__all__ = ["Recording", "TrafficRecorder", "history_digest",
           "params_sha256", "slice_trace"]

_REC_VERSION = 1


def params_sha256(params) -> str:
    """Content hash of a param pytree (leaves in ``tree_leaves`` order,
    raw bytes) -- the cheap cross-process bitwise check."""
    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        x = torch.as_tensor(leaf).detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)          # numpy has no bf16
        h.update(x.numpy().tobytes())
    return h.hexdigest()


def history_digest(history) -> List[List[Any]]:
    """JSON-stable per-round rows ``[t, m, m_actual, d2s, d2d, stream]``
    -- everything the stream runtime decides (metrics/control telemetry
    excluded: replay never recomputes live eval callbacks)."""
    return [[r.t, r.m, r.m_actual, r.d2s, r.d2d, r.stream]
            for r in history.records]


def slice_trace(trace: Optional[FaultTrace],
                K: int) -> Optional[FaultTrace]:
    """First ``K`` rounds of a trace (the early-shutdown recorder path);
    ``depart_round`` clips to ``K`` = "never departed within the run"."""
    if trace is None or trace.K == K:
        return trace
    return FaultTrace(up=trace.up[:K], latency=trace.latency[:K],
                      dup=trace.dup[:K], dup_delay=trace.dup_delay[:K],
                      depart_round=np.minimum(trace.depart_round, K))


class TrafficRecorder:
    """Accumulates one live run's measured traffic (see module doc)."""

    def __init__(self, K: int, n: int):
        self.arrival = np.full((K, n), np.inf, np.float32)
        self.drops: List[Tuple[int, int]] = []   # (round, client)
        self.closures: List[float] = []

    def land(self, r: int, client: int, offset: np.float32) -> None:
        self.arrival[r, client] = offset

    def drop(self, r: int, client: int) -> None:
        self.drops.append((int(r), int(client)))

    def close_round(self, C_t: float) -> None:
        self.closures.append(float(C_t))

    def finalize(self, plan: RoundPlan, stream,
                 trace: Optional[FaultTrace],
                 meta: Dict[str, Any]) -> "Recording":
        """Package the run.  ``plan`` is the realized plan the engine
        executed; its arrival column is replaced by the measured one and
        both plan and trace are sliced to the rounds actually closed
        (graceful shutdown mid-plan still yields a loadable, replayable
        artifact)."""
        K_done = len(self.closures)
        realized = plan.with_arrivals(self.arrival)[:K_done]
        if meta.get("clock") == "wall":
            realized = realized.with_source("measured")
        policy = {
            "buffer": stream.buffer,
            "deadline": stream.deadline,
            "staleness": stream.staleness,
            "staleness_param": stream.staleness_param,
            "max_staleness": stream.max_staleness,
            "client_optim": stream.client_optim,
        }
        meta = dict(meta)
        meta["drops"] = [list(d) for d in self.drops]
        meta["rounds_done"] = K_done
        return Recording(plan=realized, stream=policy,
                         trace=slice_trace(trace, K_done),
                         closures=list(self.closures), meta=meta)


@dataclasses.dataclass
class Recording:
    """One replayable ingestion-run artifact (see module docstring).

    ``meta`` carries (at least) ``history`` (``history_digest`` rows),
    ``params_sha256``, ``drops``, ``rounds_done``, ``clock``,
    ``time_scale``, ``overlap``, and ``wall_seconds``.
    """

    plan: RoundPlan
    stream: Dict[str, Any]
    trace: Optional[FaultTrace]
    closures: List[float]
    meta: Dict[str, Any]

    def stream_config(self):
        """The replay-side server policy: identical closure parameters,
        no generative fault spec (the realization is in the artifact)."""
        from repro_torch.fl.stream import StreamConfig
        deadline = self.stream.get("deadline")
        return StreamConfig(
            buffer=self.stream.get("buffer"),
            deadline=np.inf if deadline is None else deadline,
            staleness=self.stream.get("staleness", "none"),
            staleness_param=self.stream.get("staleness_param", 0.5),
            max_staleness=self.stream.get("max_staleness", 16),
            client_optim=self.stream.get("client_optim"))

    def replay(self, loss_fn, params, batches, *, backend: str = "einsum",
               device=None, eval_fn=None, eval_every: int = 1,
               energy_ratio: float = 0.1):
        """Re-execute the recording through the virtual-time
        ``StreamEngine`` on ``device`` (``cuda`` unless given).
        ``params``/``batches`` must be the live run's inputs (the
        recording pins traffic, not data); ``batches`` longer than the
        recorded horizon (early shutdown) is sliced."""
        from repro_torch.fl.engine import ExecutionConfig, make_engine
        cfg = ExecutionConfig(backend=backend, stream=self.stream_config())
        engine = make_engine(cfg, loss_fn, device=device)
        return engine.execute(self.plan, params,
                              batches[:self.plan.n_rounds],
                              eval_fn=eval_fn, eval_every=eval_every,
                              energy_ratio=energy_ratio,
                              trace=self.trace)

    def verify(self, loss_fn, params, batches, *,
               backend: str = "einsum", device=None) -> List[str]:
        """Replay and diff against the recorded History digest + params
        hash.  Returns human-readable mismatch lines (empty = the
        live/replay anchor holds bitwise)."""
        final, history = self.replay(loss_fn, params, batches,
                                     backend=backend, device=device)
        problems: List[str] = []
        got = history_digest(history)
        want = self.meta.get("history")
        if want is not None:
            if len(got) != len(want):
                problems.append(f"history length: live {len(want)} vs "
                                f"replay {len(got)}")
            for live, rep in zip(want, got):
                if list(live) != list(rep):
                    problems.append(f"round {live[0]}: live {live} vs "
                                    f"replay {rep}")
        want_sha = self.meta.get("params_sha256")
        got_sha = params_sha256(final)
        if want_sha is not None and got_sha != want_sha:
            problems.append(f"params sha256: live {want_sha[:16]}... vs "
                            f"replay {got_sha[:16]}...")
        return problems

    # -- serialization ------------------------------------------------------

    def as_dict(self) -> Dict[str, Any]:
        return {
            "version": _REC_VERSION,
            "plan": json.loads(self.plan.to_json()),
            "stream": dict(self.stream),
            "trace": None if self.trace is None else self.trace.as_dict(),
            "closures": [float(c) for c in self.closures],
            "meta": _jsonable(self.meta),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Recording":
        if d.get("version") != _REC_VERSION:
            raise ValueError(
                f"unsupported Recording version {d.get('version')!r}")
        trace = d.get("trace")
        return cls(plan=RoundPlan.from_json(json.dumps(d["plan"])),
                   stream=dict(d["stream"]),
                   trace=None if trace is None
                   else FaultTrace.from_dict(trace),
                   closures=[float(c) for c in d.get("closures", [])],
                   meta=dict(d.get("meta", {})))

    def to_json(self) -> str:
        # deadline=inf is not JSON; policy floats pass through _jsonable
        d = self.as_dict()
        d["stream"] = _jsonable(d["stream"])
        return json.dumps(d)

    @classmethod
    def from_json(cls, text: str) -> "Recording":
        d = json.loads(text)
        s = d.get("stream", {})
        if s.get("deadline") is None:
            s["deadline"] = np.inf
        return cls.from_dict(d)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Recording":
        with open(path) as f:
            return cls.from_json(f.read())


def _jsonable(obj):
    """inf -> None, numpy scalars -> python, containers recursed -- the
    meta/policy blocks stay plain JSON."""
    import math
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, float)):
        f = float(obj)
        return None if math.isinf(f) else f
    if isinstance(obj, (np.integer,)):
        return int(obj)
    return obj
