"""Declarative fault injection: serializable fault models + replayable traces.

The paper's premise -- time-varying D2D connectivity with a threshold
``m_t`` on participating clients -- only matters because real edge
clients fail, stall, upload late, or disappear.  This module makes that
*failure process* a first-class declarative object, exactly like
``repro_torch.topology.TopologySpec`` made the connectivity process one:

* ``FaultSpec``   -- a frozen, JSON-exact description of the failure
  process: a client availability model (``failures``), an upload
  latency distribution (``latency``), duplicate-delivery and permanent-
  departure rates.  ``spec == FaultSpec.from_json(spec.to_json())``.
* ``sample_trace`` -- ``FaultSpec`` + (n, K, seed) -> ``FaultTrace``:
  every stochastic draw of the whole trajectory materialized as host
  arrays in ONE documented rng order, so a fault trajectory is
  bitwise-replayable from spec + seed (the semi-async stream engine,
  still to be ported, consumes traces, never raw randomness).
* ``FaultTrace``  -- the realized trajectory (availability mask, per-
  upload latencies, duplicate flags/delays, departure rounds), itself
  JSON round-trippable so an *executed* fault history is a pinned
  artifact independent of the generative spec.

Availability models double as the straggler mask generators behind the
``RoundPlan`` dropout transforms (``with_dropout`` /
``with_markov_dropout`` / ``with_cluster_dropout`` delegate here), so
the stream engine's failure chains and the synchronous plan transforms
draw from literally the same code -- same rng consumption order, same
masks, bitwise.

Failure semantics downstream (the reference's ``repro.fl.stream``): an unavailable
client neither mixes (D2D) nor uploads that round; a late upload is
buffered and folded into a later aggregation with a staleness discount;
a duplicate is deduplicated but billed as uplink; a departed client is
unavailable for every remaining round.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

__all__ = [
    "FAILURE_KINDS", "LATENCY_KINDS", "FaultSpec", "FaultTrace",
    "sample_trace", "parse_fault_spec", "draw_latency",
    "iid_active", "markov_active", "cluster_active",
]

FAILURE_KINDS = ("none", "iid", "markov", "cluster")
LATENCY_KINDS = ("zero", "fixed", "uniform", "exponential", "lognormal")

_FAILURE_PARAMS: Dict[str, Dict[str, float]] = {
    "none": {},
    "iid": {"rate": 0.1},
    "markov": {"p_fail": 0.1, "p_recover": 0.5},
    "cluster": {"rate": 0.1},
}

_LATENCY_PARAMS: Dict[str, Dict[str, float]] = {
    "zero": {},
    "fixed": {"value": 0.5},
    "uniform": {"lo": 0.0, "hi": 1.0},
    "exponential": {"mean": 0.5},
    "lognormal": {"mu": -1.0, "sigma": 0.5},
}


# ---------------------------------------------------------------------------
# Availability mask generators (the PR-5 dropout models, extracted).
#
# These are the single source of the mask rng streams: the RoundPlan
# transforms call them with the exact draw order the pre-extraction
# inline loops used, so pre-existing seeded trajectories stay bitwise.
# ---------------------------------------------------------------------------

def iid_active(rng: np.random.Generator, K: int, n: int,
               rate: float) -> np.ndarray:
    """(K, n) 0/1 mask: each client independently down with probability
    ``rate`` per round (memoryless single-round outages)."""
    return (rng.random((K, n)) >= rate).astype(np.float32)


def markov_active(rng: np.random.Generator, K: int, n: int,
                  p_fail: float, p_recover: float) -> np.ndarray:
    """(K, n) 0/1 mask from independent two-state Markov chains: fail
    w.p. ``p_fail`` per round, recover w.p. ``p_recover`` (mean outage
    ``1/p_recover`` rounds).  Chains start from the stationary
    distribution, so the marginal dropout rate is constant from t=0."""
    pi_active = (p_recover / (p_fail + p_recover)
                 if p_fail + p_recover > 0 else 1.0)
    state = rng.random(n) < pi_active
    mask = np.empty((K, n), np.float32)
    for t in range(K):
        mask[t] = state
        u = rng.random(n)
        state = np.where(state, u >= p_fail, u < p_recover)
    return mask


def cluster_active(rng: np.random.Generator, K: int,
                   partition: Sequence[np.ndarray], n: int,
                   rate: float) -> np.ndarray:
    """(K, n) 0/1 mask: each cluster independently drops *all* of its
    clients with probability ``rate`` per round (an access point going
    dark -- spatially-correlated outages)."""
    mask = np.ones((K, n), np.float32)
    for t in range(K):
        for verts in partition:
            if rng.random() < rate:
                mask[t, np.asarray(verts)] = 0.0
    return mask


# ---------------------------------------------------------------------------
# FaultSpec.
# ---------------------------------------------------------------------------

def _check_prob(name: str, p: float, hi_inclusive: bool = True) -> None:
    ok = 0.0 <= p <= 1.0 if hi_inclusive else 0.0 <= p < 1.0
    if not ok:
        hi = "<= 1" if hi_inclusive else "< 1"
        raise ValueError(f"need 0 <= {name} {hi}, got {p}")


def _merged_params(kind: str, given: Mapping[str, Any],
                   table: Mapping[str, Dict[str, float]],
                   what: str) -> Dict[str, float]:
    if kind not in table:
        raise ValueError(f"{what} must be one of {tuple(table)}, "
                         f"got {kind!r}")
    defaults = table[kind]
    unknown = sorted(set(given) - set(defaults))
    if unknown:
        raise ValueError(
            f"unknown parameter(s) {unknown} for {what} {kind!r}; "
            f"valid: {sorted(defaults)}")
    return {k: float(given.get(k, v)) for k, v in defaults.items()}


@dataclasses.dataclass(frozen=True, eq=True)
class FaultSpec:
    """One serializable description of a failure process.

    Parameters are normalized at construction (unknown names raise,
    missing ones fill from the kind's defaults), so two specs describing
    the same process compare equal even when one came through JSON.
    """

    failures: str = "none"
    failure_params: Mapping[str, Any] = \
        dataclasses.field(default_factory=dict)
    latency: str = "zero"
    latency_params: Mapping[str, Any] = \
        dataclasses.field(default_factory=dict)
    duplicate_rate: float = 0.0
    depart_rate: float = 0.0

    def __post_init__(self):
        object.__setattr__(
            self, "failure_params",
            _merged_params(self.failures, dict(self.failure_params),
                           _FAILURE_PARAMS, "failures"))
        object.__setattr__(
            self, "latency_params",
            _merged_params(self.latency, dict(self.latency_params),
                           _LATENCY_PARAMS, "latency"))
        object.__setattr__(self, "duplicate_rate",
                           float(self.duplicate_rate))
        object.__setattr__(self, "depart_rate", float(self.depart_rate))
        fp = self.failure_params
        if self.failures == "iid" or self.failures == "cluster":
            _check_prob("rate", fp["rate"], hi_inclusive=False)
        elif self.failures == "markov":
            _check_prob("p_fail", fp["p_fail"])
            _check_prob("p_recover", fp["p_recover"])
        lp = self.latency_params
        if self.latency == "fixed" and lp["value"] < 0:
            raise ValueError(f"need value >= 0, got {lp['value']}")
        if self.latency == "uniform" and not 0 <= lp["lo"] <= lp["hi"]:
            raise ValueError(f"need 0 <= lo <= hi, got "
                             f"lo={lp['lo']}, hi={lp['hi']}")
        if self.latency == "exponential" and lp["mean"] <= 0:
            raise ValueError(f"need mean > 0, got {lp['mean']}")
        if self.latency == "lognormal" and lp["sigma"] < 0:
            raise ValueError(f"need sigma >= 0, got {lp['sigma']}")
        _check_prob("duplicate_rate", self.duplicate_rate)
        _check_prob("depart_rate", self.depart_rate)

    # dict fields defeat the generated __hash__; identity by content.
    def __hash__(self):
        return hash(self.to_json())

    def as_dict(self) -> Dict[str, Any]:
        return {
            "failures": self.failures,
            "failure_params": dict(self.failure_params),
            "latency": self.latency,
            "latency_params": dict(self.latency_params),
            "duplicate_rate": self.duplicate_rate,
            "depart_rate": self.depart_rate,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FaultSpec":
        return cls(failures=d.get("failures", "none"),
                   failure_params=d.get("failure_params", {}),
                   latency=d.get("latency", "zero"),
                   latency_params=d.get("latency_params", {}),
                   duplicate_rate=d.get("duplicate_rate", 0.0),
                   depart_rate=d.get("depart_rate", 0.0))

    def to_json(self) -> str:
        return json.dumps(self.as_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultSpec":
        return cls.from_dict(json.loads(text))


_RESERVED = ("latency", "duplicate_rate", "depart_rate")


def parse_fault_spec(text: str) -> FaultSpec:
    """CLI syntax ``failures:key=val,...`` -> validated spec.

    ``latency=KIND`` selects the latency distribution; its parameters
    (``value`` / ``lo`` / ``hi`` / ``mean`` / ``mu`` / ``sigma``) ride in
    the same flat list, as do ``duplicate_rate`` and ``depart_rate``.
    Examples::

        markov:p_fail=0.2,p_recover=0.5,latency=exponential,mean=0.6
        iid:rate=0.1,latency=uniform,lo=0.1,hi=1.2,duplicate_rate=0.05
        none:latency=fixed,value=0.3,depart_rate=0.01
    """
    failures, _, rest = text.partition(":")
    failures = failures.strip() or "none"
    kv: Dict[str, Any] = {}
    if rest.strip():
        for item in rest.split(","):
            key, eq, val = item.partition("=")
            if not eq:
                raise ValueError(
                    f"malformed fault option {item!r} (want key=val)")
            key = key.strip()
            kv[key] = val.strip() if key == "latency" else float(val)
    latency = str(kv.pop("latency", "zero"))
    dup = kv.pop("duplicate_rate", 0.0)
    depart = kv.pop("depart_rate", 0.0)
    lat_keys = set(_LATENCY_PARAMS.get(latency, {}))
    lat_params = {k: kv.pop(k) for k in list(kv) if k in lat_keys}
    return FaultSpec(failures=failures, failure_params=kv,
                     latency=latency, latency_params=lat_params,
                     duplicate_rate=dup, depart_rate=depart)


# ---------------------------------------------------------------------------
# FaultTrace: the realized trajectory.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class FaultTrace:
    """One realized fault trajectory over (K rounds, n clients).

    ``up`` is the failure-chain availability alone; ``active`` folds in
    permanent departures (a client is gone from ``depart_round``
    onward).  ``arrival`` is the per-upload delay after round dispatch,
    ``inf`` where the client never delivers (down or departed).
    """

    up: np.ndarray            # (K, n) f32 0/1 availability (chains only)
    latency: np.ndarray       # (K, n) f32 upload delay after dispatch
    dup: np.ndarray           # (K, n) f32 0/1 duplicate delivered
    dup_delay: np.ndarray     # (K, n) f32 extra delay of the duplicate
    depart_round: np.ndarray  # (n,)   i64 first departed round (K: never)

    def __post_init__(self):
        K, n = self.up.shape
        for name in ("latency", "dup", "dup_delay"):
            if getattr(self, name).shape != (K, n):
                raise ValueError(
                    f"{name} must be ({K}, {n}), got "
                    f"{getattr(self, name).shape}")
        if self.depart_round.shape != (n,):
            raise ValueError(f"depart_round must be ({n},), got "
                             f"{self.depart_round.shape}")

    @property
    def K(self) -> int:
        return int(self.up.shape[0])

    @property
    def n(self) -> int:
        return int(self.up.shape[1])

    @property
    def active(self) -> np.ndarray:
        """(K, n) 0/1: up AND not yet departed."""
        t = np.arange(self.K)[:, None]
        return (self.up * (t < self.depart_round[None, :])) \
            .astype(np.float32)

    @property
    def arrival(self) -> np.ndarray:
        """(K, n) upload delay after dispatch; inf where never
        delivered (the ``RoundPlan.arrival_t`` column)."""
        return np.where(self.active > 0, self.latency,
                        np.float32(np.inf)).astype(np.float32)

    def as_dict(self) -> Dict[str, Any]:
        def col(a):
            return [[None if not math.isfinite(v) else v for v in row]
                    for row in a.tolist()]
        return {"up": self.up.tolist(), "latency": col(self.latency),
                "dup": self.dup.tolist(),
                "dup_delay": col(self.dup_delay),
                "depart_round": self.depart_round.tolist()}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FaultTrace":
        def col(rows):
            return np.asarray([[math.inf if v is None else v for v in row]
                               for row in rows], np.float32)
        return cls(up=np.asarray(d["up"], np.float32),
                   latency=col(d["latency"]),
                   dup=np.asarray(d["dup"], np.float32),
                   dup_delay=col(d["dup_delay"]),
                   depart_round=np.asarray(d["depart_round"], np.int64))

    def to_json(self) -> str:
        return json.dumps(self.as_dict())

    @classmethod
    def from_json(cls, text: str) -> "FaultTrace":
        return cls.from_dict(json.loads(text))

    def allclose(self, other: "FaultTrace") -> bool:
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if a.shape != b.shape or a.dtype != b.dtype:
                return False
            eq = (a == b) | (np.isinf(a) & np.isinf(b))
            if not eq.all():
                return False
        return True


def _draw_latency(rng: np.random.Generator, kind: str,
                  params: Mapping[str, float],
                  shape) -> np.ndarray:
    if kind == "zero":
        return np.zeros(shape, np.float32)
    if kind == "fixed":
        return np.full(shape, params["value"], np.float32)
    if kind == "uniform":
        lo, hi = params["lo"], params["hi"]
        return (rng.random(shape) * (hi - lo) + lo).astype(np.float32)
    if kind == "exponential":
        return rng.exponential(params["mean"], shape).astype(np.float32)
    if kind == "lognormal":
        return rng.lognormal(params["mu"], params["sigma"], shape) \
            .astype(np.float32)
    raise ValueError(f"latency must be one of {LATENCY_KINDS}, "
                     f"got {kind!r}")   # pragma: no cover - spec validates


def draw_latency(rng: np.random.Generator, kind: str,
                 params: Optional[Mapping[str, float]] = None,
                 shape=()) -> np.ndarray:
    """Public latency sampler: one draw from a ``LATENCY_KINDS``
    distribution with defaults filled in, float32.  The wall-clock
    runtime's load generators and benchmarks sample ad-hoc virtual
    latencies through this instead of hand-rolling distributions, so
    their draws match what ``sample_trace`` would have produced for the
    same rng state."""
    merged = _merged_params(kind, dict(params or {}), _LATENCY_PARAMS,
                            "latency")
    return _draw_latency(rng, kind, merged, shape)


def sample_trace(spec: FaultSpec, n: int, K: int, *,
                 seed: Optional[int] = 0,
                 rng: Optional[np.random.Generator] = None,
                 partition: Optional[Sequence[np.ndarray]] = None
                 ) -> FaultTrace:
    """Materialize one fault trajectory from ``spec``.

    The rng order is frozen (availability, upload latencies, duplicate
    flags, duplicate delays, departures) and every stage draws
    unconditionally, so the trace -- and therefore the whole stream
    execution -- replays bitwise from ``spec`` + ``seed``.  ``partition``
    is required by (and only by) ``failures='cluster'``.
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    fp = dict(spec.failure_params)
    if spec.failures == "none":
        up = np.ones((K, n), np.float32)
    elif spec.failures == "iid":
        up = iid_active(rng, K, n, fp["rate"])
    elif spec.failures == "markov":
        up = markov_active(rng, K, n, fp["p_fail"], fp["p_recover"])
    elif spec.failures == "cluster":
        if partition is None:
            raise ValueError(
                "failures='cluster' needs a partition (e.g. from the "
                "plan's embedded topology spec)")
        up = cluster_active(rng, K, partition, n, fp["rate"])
    else:   # pragma: no cover - spec validates
        raise ValueError(f"unknown failures kind {spec.failures!r}")

    latency = _draw_latency(rng, spec.latency, spec.latency_params, (K, n))
    dup = (rng.random((K, n)) < spec.duplicate_rate).astype(np.float32)
    dup_delay = _draw_latency(rng, spec.latency, spec.latency_params,
                              (K, n))
    u = rng.random((K, n)) < spec.depart_rate
    first = np.argmax(u, axis=0)
    depart = np.where(u.any(axis=0), first, K).astype(np.int64)
    return FaultTrace(up=up, latency=latency, dup=dup,
                      dup_delay=dup_delay, depart_round=depart)
