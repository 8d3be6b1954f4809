"""Declarative controller layer: serializable specs + a registry (numpy-only
copy of ``repro.control.base``).

The planning layer (``repro_torch.fl.plan``) is *open-loop*: every
``(A_t, tau_t, m_t, eta_t)`` column is fixed before round 0 from the
topology spec alone.  This package closes the loop -- paper Sec. 5's
observation that the threshold rule (7) needs only the *current* graph's
connectivity makes the m(t) decision an online policy, not a plan:

* ``ControllerSpec`` -- a frozen, JSON-serializable description of a
  control policy: ``family`` (registry name) + parameters.  Round-trips
  through JSON exactly, in the style of ``TopologySpec``/``FaultSpec``.
* ``Controller``     -- the decision protocol: once per round the
  control loop shows the policy what actually materialized
  (``RealizedRound``: realized per-cluster connectivity, the open-loop
  rule's m, cluster sizes) together with the previous round's
  ``RoundRecord``, and the policy answers with a ``Decision``:
  how many clients to sample (``m``), how many D2D gossip iterations to
  run (``tau``), which relay scheme, optionally a step-size override.
* the registry      -- ``register``/``make_spec``/``build``/
  ``parse_spec`` mirror ``repro_torch.topology.base`` exactly, including the
  CLI syntax ``family:key=val,...`` (``repro_torch.launch.train
  --controller``).

Controllers are *pure policies*: they never touch the planning rng
stream (``ControlLoop`` owns topology sampling and client sampling), so
a controlled run is always replayable from its emitted ``RoundPlan`` --
and, when the policy leaves the graph and the columns untouched
(``static``), regenerable from spec + seed, bitwise.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Type

import numpy as np

from repro_torch.topology.base import _freeze, _parse_value, _thaw

__all__ = [
    "ControllerSpec",
    "Decision",
    "RealizedRound",
    "Controller",
    "register",
    "controllers",
    "controller_defaults",
    "make_spec",
    "build",
    "from_json",
    "parse_spec",
]

SCHEMES = ("all", "sampled")


@dataclasses.dataclass(frozen=True, eq=True)
class ControllerSpec:
    """One serializable description of a control policy.

    ``params`` are normalized (``_freeze``) at construction so two specs
    describing the same policy compare equal even when one came through
    JSON.  Prefer ``make_spec`` (validates names and fills family
    defaults) over constructing directly.
    """

    family: str
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "params", _freeze(dict(self.params)))

    # dict fields defeat the generated __hash__; identity by content.
    def __hash__(self):
        return hash(self.to_json())

    def as_dict(self) -> Dict[str, Any]:
        return {"family": self.family, "params": _thaw(dict(self.params))}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ControllerSpec":
        return cls(family=d["family"], params=d.get("params", {}))

    def to_json(self) -> str:
        return json.dumps(self.as_dict(), sort_keys=True)

    def build(self) -> "Controller":
        return build(self)


@dataclasses.dataclass(frozen=True)
class Decision:
    """What a controller decides for one round.

    ``m``      -- clients the PS samples this round (clamped to [1, n]
                  by the loop).
    ``tau``    -- D2D gossip iterations: the emitted mixing matrix is
                  the cluster-blockwise ``tau``-th power of the
                  equal-neighbor matrix (``tau = 1`` leaves it
                  untouched -- the bitwise fast path).
    ``scheme`` -- ``'all'``: every client relays (the paper's setting);
                  ``'sampled'``: only PS-sampled clients relay --
                  unsampled columns collapse to ``e_j`` (the client
                  keeps its own value and broadcasts nothing), which
                  preserves column-stochasticity.
    ``eta``    -- optional step-size override; ``None`` keeps the
                  planned ``config.eta(t)``.
    """

    m: int
    tau: int = 1
    scheme: str = "all"
    eta: Optional[float] = None

    def __post_init__(self):
        if int(self.m) < 1:
            raise ValueError(f"Decision.m must be >= 1, got {self.m}")
        if int(self.tau) < 1:
            raise ValueError(f"Decision.tau must be >= 1, got {self.tau}")
        if self.scheme not in SCHEMES:
            raise ValueError(
                f"Decision.scheme must be one of {SCHEMES}, "
                f"got {self.scheme!r}")
        if self.eta is not None and not float(self.eta) > 0.0:
            raise ValueError(f"Decision.eta must be > 0, got {self.eta}")


@dataclasses.dataclass(frozen=True)
class RealizedRound:
    """What the control loop observed about round ``t`` *before* client
    sampling: the realized topology draw, digested.

    ``psis``   -- per-cluster ``config.bound_kind`` psi bounds (what the
                  open-loop planner uses).
    ``phis``   -- per-cluster *realized* ``exact_phi_ell`` values
                  (``None`` when the controller declared
                  ``needs_phi = False``; computed CSR-natively on the
                  sparse path -- see ``exact_phi_ell_sparse``).
    ``m_rule`` -- the m the open-loop eq.-7 rule would use this round
                  (``m0``/``n`` at t=0, else ``min_clients`` on
                  ``psis``): the ``static`` policy's whole decision.
    """

    t: int
    n: int
    sizes: Tuple[int, ...]
    psis: Tuple[float, ...]
    phis: Optional[Tuple[float, ...]]
    m_rule: int
    phi_max: float


class Controller:
    """Policy base class.  Subclasses declare ``DEFAULTS`` (complete
    parameter dict), set the capability flags, and implement
    ``observe``.

    ``needs_phi``    -- the loop computes realized per-cluster
                        ``exact_phi_ell`` each round (a power iteration
                        on the sparse path; skipped when False so
                        ``static`` adds zero per-round cost).
    ``needs_deltas`` -- the engine flattens each round's client deltas
                        to an (n, P) array and calls ``feed`` (the
                        learned-topology path; forces an extra deltas
                        evaluation per round).
    """

    DEFAULTS: Dict[str, Any] = {}
    needs_phi: bool = True
    needs_deltas: bool = False

    def __init__(self, spec: ControllerSpec):
        unknown = sorted(set(spec.params) - set(self.DEFAULTS))
        if unknown:
            raise ValueError(
                f"unknown parameter(s) {unknown} for controller "
                f"{spec.family!r}; valid: {sorted(self.DEFAULTS)}")
        self.spec = spec
        self._params = {**self.DEFAULTS, **dict(spec.params)}

    def reset(self, network, config) -> None:
        """Bind to a run: called once by ``ControlLoop`` before round 0.
        ``network`` is the topology model, ``config`` the
        ``ServerConfig``.  Subclasses extending this must chain up."""
        self._network = network
        self._config = config

    def observe(self, record, realized: RealizedRound) -> Decision:
        """One control step.  ``record`` is the previous round's
        ``RoundRecord`` (``None`` at t=0), ``realized`` the current
        topology draw's digest.  Must not consume any rng."""
        raise NotImplementedError

    def feed(self, record, deltas: np.ndarray) -> None:
        """Post-round hook: the (n, P) per-client delta matrix of the
        round just executed.  Only called when ``needs_deltas``."""


# ---------------------------------------------------------------------------
# Registry (mirrors repro_torch.topology.base).
# ---------------------------------------------------------------------------

_CONTROLLERS: Dict[str, Type[Controller]] = {}


def register(name: str) -> Callable[[type], type]:
    """Class decorator: bind a controller class to a family name.  The
    class must define ``DEFAULTS`` and accept a ``ControllerSpec`` as
    its only constructor argument."""
    def deco(cls):
        if name in _CONTROLLERS:
            raise ValueError(f"controller family {name!r} already registered")
        if not hasattr(cls, "DEFAULTS"):
            raise TypeError(f"{cls.__name__} must declare DEFAULTS")
        cls.FAMILY = name
        _CONTROLLERS[name] = cls
        return cls
    return deco


def controllers() -> Tuple[str, ...]:
    """All registered controller family names (sorted)."""
    return tuple(sorted(_CONTROLLERS))


def controller_defaults(family: str) -> Dict[str, Any]:
    return dict(_controller_class(family).DEFAULTS)


def _controller_class(family: str) -> Type[Controller]:
    try:
        return _CONTROLLERS[family]
    except KeyError:
        raise ValueError(f"unknown controller family {family!r}; "
                         f"registered: {controllers()}") from None


def make_spec(family: str, **params: Any) -> ControllerSpec:
    """Validated spec construction: unknown parameter names raise, and
    missing ones are filled from the family's declared defaults (so
    every spec serializes *complete*)."""
    defaults = controller_defaults(family)
    unknown = sorted(set(params) - set(defaults))
    if unknown:
        raise ValueError(
            f"unknown parameter(s) {unknown} for controller {family!r}; "
            f"valid: {sorted(defaults)}")
    return ControllerSpec(family=family, params={**defaults, **params})


def build(spec: ControllerSpec) -> Controller:
    """Spec -> a fresh controller instance (fresh policy state)."""
    return _controller_class(spec.family)(spec)


def from_json(text: str) -> Controller:
    """Registry round-trip: JSON written by ``spec.to_json()`` ->
    controller."""
    return build(ControllerSpec.from_dict(json.loads(text)))


def parse_spec(text: str) -> ControllerSpec:
    """CLI syntax ``family[:key=val,...]`` -> validated spec.  Examples::

        static
        threshold:phi_max=0.25
        similarity:graph_every=2,ema=0.7
    """
    family, _, rest = text.partition(":")
    family = family.strip()
    kv: Dict[str, Any] = {}
    if rest.strip():
        for item in rest.split(","):
            key, eq, val = item.partition("=")
            if not eq:
                raise ValueError(
                    f"malformed controller option {item!r} (want key=val)")
            kv[key.strip()] = _parse_value(val)
    return make_spec(family, **kv)
