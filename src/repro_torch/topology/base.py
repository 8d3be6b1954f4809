"""Declarative topology layer: serializable specs + a family registry.

The paper's contribution is *connectivity-awareness*: the convergence /
communication trade-off is driven by the top-two singular values of
time-varying, directed cluster graphs (Sec. 3.3, 5).  This package makes
the graph generator a first-class, declarative object instead of one
hardcoded generative model:

* ``TopologySpec``  -- a frozen, JSON-serializable description of a
  time-varying D2D network: graph ``family`` (registry name), network
  size ``n`` / cluster count ``c``, family parameters, and the
  cluster-``membership`` scheme.  ``spec.to_json()`` /
  ``topology.from_json(text)`` round-trip exactly, so a spec can ride
  inside a ``RoundPlan`` artifact as topology provenance.
* ``TopologyModel`` -- the sampling protocol: ``sample(rng, t) ->
  List[ClusterGraph]``.  Models may be *time-correlated* (mobility,
  periodic re-clustering), not just i.i.d. per round: ``t`` is the
  global round index and stateful families require consecutive calls
  ``t = 0, 1, 2, ...`` (``t = 0`` resets, so one model instance can
  generate many trajectories).
* the registry     -- ``register`` binds a family name to a model
  class; ``make_spec`` validates/normalizes parameters against the
  family's declared defaults; ``build`` turns a spec into a model;
  ``parse_spec`` reads the CLI syntax ``family:key=val,...``.

Cluster membership is orthogonal to the graph family:

* ``equal``    -- ``c`` contiguous clusters of ``n/c`` (the paper's
  Sec. 6.1.1 setting, bitwise-identical to the legacy ``D2DNetwork``
  default partition)
* ``skewed``   -- contiguous clusters with sizes proportional to
  ``gamma**l`` (size heterogeneity across clusters)
* ``explicit`` -- a caller-provided partition (tuple of tuples)

plus ``recluster_every=R`` (any scheme): every ``R`` rounds the clients
are re-shuffled into fresh clusters of the same sizes -- cluster
*formation* as a time-varying design variable.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Protocol, \
    Sequence, Tuple, Type

import numpy as np

from repro_torch.core.graphs import ClusterGraph, SparseClusterGraph

__all__ = [
    "TopologySpec",
    "TopologyModel",
    "ClusteredTopology",
    "MEMBERSHIPS",
    "make_partition",
    "register",
    "families",
    "family_defaults",
    "make_spec",
    "build",
    "from_json",
    "parse_spec",
]

MEMBERSHIPS = ("equal", "skewed", "explicit")

_MEMBERSHIP_PARAMS = {
    "equal": {"recluster_every": 0},
    "skewed": {"recluster_every": 0, "gamma": 0.7},
    "explicit": {"recluster_every": 0, "partition": ()},
}


def _freeze(value):
    """Normalize JSON-ambiguous containers to hashable/equatable forms
    (lists -> tuples, recursively) so spec -> JSON -> spec is *exact*
    under dataclass equality."""
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, dict):
        return {k: _freeze(v) for k, v in value.items()}
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, np.ndarray):
        return tuple(_freeze(v) for v in value.tolist())
    return value


def _thaw(value):
    """Tuples -> lists, recursively (the JSON-facing image of _freeze)."""
    if isinstance(value, tuple):
        return [_thaw(v) for v in value]
    if isinstance(value, dict):
        return {k: _thaw(v) for k, v in value.items()}
    return value


@dataclasses.dataclass(frozen=True, eq=True)
class TopologySpec:
    """One serializable description of a time-varying D2D network.

    ``params`` / ``membership_params`` are normalized (_freeze) at
    construction so two specs describing the same network compare equal
    even when one came through JSON.  Prefer ``make_spec`` (validates
    names and fills family defaults) over constructing directly.
    """

    family: str
    n: int
    c: int
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    membership: str = "equal"
    membership_params: Mapping[str, Any] = \
        dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.n < 1 or self.c < 1 or self.c > self.n:
            raise ValueError(f"need 1 <= c <= n, got n={self.n}, c={self.c}")
        if self.membership not in MEMBERSHIPS:
            raise ValueError(
                f"membership must be one of {MEMBERSHIPS}, "
                f"got {self.membership!r}")
        object.__setattr__(self, "params", _freeze(dict(self.params)))
        object.__setattr__(self, "membership_params",
                           _freeze(dict(self.membership_params)))

    # dict fields defeat the generated __hash__; identity by content.
    def __hash__(self):
        return hash(self.to_json())

    def as_dict(self) -> Dict[str, Any]:
        return {
            "family": self.family,
            "n": self.n,
            "c": self.c,
            "params": _thaw(dict(self.params)),
            "membership": self.membership,
            "membership_params": _thaw(dict(self.membership_params)),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TopologySpec":
        return cls(family=d["family"], n=int(d["n"]), c=int(d["c"]),
                   params=d.get("params", {}),
                   membership=d.get("membership", "equal"),
                   membership_params=d.get("membership_params", {}))

    def to_json(self) -> str:
        return json.dumps(self.as_dict(), sort_keys=True)

    def build(self) -> "TopologyModel":
        return build(self)


class TopologyModel(Protocol):
    """What planners (``repro_torch.fl.plan.plan_rows``) need from a
    network."""

    spec: TopologySpec

    @property
    def n(self) -> int: ...

    @property
    def partition(self) -> List[np.ndarray]: ...

    def sample(self, rng: np.random.Generator, t: int = 0
               ) -> List[ClusterGraph]: ...

    def sample_sparse(self, rng: np.random.Generator, t: int = 0
                      ) -> List[SparseClusterGraph]: ...


# ---------------------------------------------------------------------------
# Cluster membership.
# ---------------------------------------------------------------------------

def make_partition(n: int, c: int, membership: str = "equal",
                   params: Optional[Mapping[str, Any]] = None
                   ) -> List[np.ndarray]:
    """The t=0 cluster membership: a list of ``c`` disjoint vertex sets
    covering ``[n]``."""
    params = dict(params or {})
    if membership == "equal":
        if n % c != 0:
            raise ValueError(f"'equal' membership needs c | n "
                             f"(n={n}, c={c})")
        per = n // c
        return [np.arange(l * per, (l + 1) * per) for l in range(c)]
    if membership == "skewed":
        gamma = float(params.get("gamma", 0.7))
        if not 0.0 < gamma <= 1.0:
            raise ValueError(f"need 0 < gamma <= 1, got {gamma}")
        w = gamma ** np.arange(c)
        sizes = np.floor(n * w / w.sum()).astype(int)
        sizes = np.maximum(sizes, 1)
        # largest-remainder correction onto the biggest cluster keeps
        # every cluster non-empty and the sizes summing to n
        while sizes.sum() > n:
            sizes[int(np.argmax(sizes))] -= 1
        sizes[0] += n - sizes.sum()
        bounds = np.concatenate([[0], np.cumsum(sizes)])
        return [np.arange(bounds[l], bounds[l + 1]) for l in range(c)]
    if membership == "explicit":
        part = params.get("partition")
        if not part:
            raise ValueError("'explicit' membership needs a 'partition' "
                             "parameter (tuple of vertex tuples)")
        # order preserved verbatim: vertex order feeds rng.choice in the
        # sampler, so reordering would change bitwise reproduction
        parts = [np.asarray([int(i) for i in verts]) for verts in part]
        flat = np.concatenate(parts) if parts else np.array([], int)
        if len(parts) != c or sorted(flat.tolist()) != list(range(n)):
            raise ValueError(
                f"'explicit' partition must be {c} disjoint sets covering "
                f"[{n}]")
        return parts
    raise ValueError(f"membership must be one of {MEMBERSHIPS}, "
                     f"got {membership!r}")


# ---------------------------------------------------------------------------
# Family registry.
# ---------------------------------------------------------------------------

_FAMILIES: Dict[str, Type["ClusteredTopology"]] = {}


def register(name: str) -> Callable[[type], type]:
    """Class decorator: bind a model class to a family name.  The class
    must define ``DEFAULTS`` (the complete parameter dict) and accept a
    ``TopologySpec`` as its only constructor argument."""
    def deco(cls):
        if name in _FAMILIES:
            raise ValueError(f"topology family {name!r} already registered")
        if not hasattr(cls, "DEFAULTS"):
            raise TypeError(f"{cls.__name__} must declare DEFAULTS")
        cls.FAMILY = name
        _FAMILIES[name] = cls
        return cls
    return deco


def families() -> Tuple[str, ...]:
    """All registered family names (sorted)."""
    return tuple(sorted(_FAMILIES))


def family_defaults(family: str) -> Dict[str, Any]:
    return dict(_family_class(family).DEFAULTS)


def _family_class(family: str) -> Type["ClusteredTopology"]:
    try:
        return _FAMILIES[family]
    except KeyError:
        raise ValueError(f"unknown topology family {family!r}; registered: "
                         f"{families()}") from None


def make_spec(family: str, n: int, c: int, membership: str = "equal",
              membership_params: Optional[Mapping[str, Any]] = None,
              **params: Any) -> TopologySpec:
    """Validated spec construction: unknown parameter names raise, and
    missing ones are filled from the family's declared defaults (so every
    spec serializes *complete* -- stable under default changes)."""
    defaults = family_defaults(family)
    unknown = sorted(set(params) - set(defaults))
    if unknown:
        raise ValueError(
            f"unknown parameter(s) {unknown} for family {family!r}; "
            f"valid: {sorted(defaults)}")
    m_defaults = dict(_MEMBERSHIP_PARAMS.get(membership, {}))
    m_given = dict(membership_params or {})
    unknown_m = sorted(set(m_given) - set(m_defaults))
    if unknown_m:
        raise ValueError(
            f"unknown membership parameter(s) {unknown_m} for "
            f"{membership!r}; valid: {sorted(m_defaults)}")
    return TopologySpec(family=family, n=n, c=c,
                        params={**defaults, **params},
                        membership=membership,
                        membership_params={**m_defaults, **m_given})


def build(spec: TopologySpec) -> "TopologyModel":
    """Spec -> a fresh model instance (fresh temporal state)."""
    return _family_class(spec.family)(spec)


def from_json(text: str) -> "TopologyModel":
    """Registry round-trip: JSON written by ``spec.to_json()`` -> model."""
    return build(TopologySpec.from_dict(json.loads(text)))


_RANGE_RE = re.compile(r"^(\d+)-(\d+)$")


def _parse_value(raw: str):
    raw = raw.strip()
    m = _RANGE_RE.match(raw)
    if m:                                   # "6-9" -> (6, 9) inclusive range
        return (int(m.group(1)), int(m.group(2)))
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            pass
    return raw


def parse_spec(text: str, n: int, c: int) -> TopologySpec:
    """CLI syntax ``family:key=val,...`` -> validated spec.

    ``membership=`` and membership parameters (``recluster_every``,
    ``gamma``) route to the membership scheme; integer ranges may be
    written ``lo-hi`` (e.g. ``k_range=6-9``).  Examples::

        k_regular:k_range=6-9,p_fail=0.1
        geometric:radius=0.3,speed=0.05,membership=skewed,gamma=0.6
        hub:hubs=2,recluster_every=5
    """
    family, _, rest = text.partition(":")
    family = family.strip()
    kv: Dict[str, Any] = {}
    if rest.strip():
        for item in rest.split(","):
            key, eq, val = item.partition("=")
            if not eq:
                raise ValueError(
                    f"malformed topology option {item!r} (want key=val)")
            kv[key.strip()] = _parse_value(val)
    membership = str(kv.pop("membership", "equal"))
    m_keys = set(_MEMBERSHIP_PARAMS.get(membership, {}))
    m_params = {k: kv.pop(k) for k in list(kv) if k in m_keys}
    n = int(kv.pop("n", n))
    c = int(kv.pop("c", c))
    return make_spec(family, n=n, c=c, membership=membership,
                     membership_params=m_params, **kv)


# ---------------------------------------------------------------------------
# Model base class.
# ---------------------------------------------------------------------------

class ClusteredTopology:
    """Shared machinery: membership handling + per-cluster sampling.

    Subclasses implement ``_cluster_W(rng, t, verts) -> adjacency`` and
    (for time-correlated families) the ``_reset(rng)`` / ``_advance(rng,
    t)`` state hooks.  Stateless families may be sampled at any ``t``;
    stateful ones (``time_correlated`` or ``recluster_every > 0``)
    require consecutive ``t = 0, 1, 2, ...`` with ``t = 0`` resetting the
    trajectory, so the same seeded rng stream always regenerates the
    same snapshots (the ``RoundPlan.regenerate`` contract).
    """

    time_correlated = False
    DEFAULTS: Dict[str, Any] = {}

    def __init__(self, spec: TopologySpec):
        unknown = sorted(set(spec.params) - set(self.DEFAULTS))
        if unknown:
            raise ValueError(
                f"unknown parameter(s) {unknown} for family "
                f"{spec.family!r}; valid: {sorted(self.DEFAULTS)}")
        self.spec = spec
        self._params = {**self.DEFAULTS, **dict(spec.params)}
        self._base = make_partition(spec.n, spec.c, spec.membership,
                                    spec.membership_params)
        self._recluster = int(
            dict(spec.membership_params).get("recluster_every", 0) or 0)
        if self._recluster < 0:
            raise ValueError("recluster_every must be >= 0")
        self._partition = [np.asarray(v) for v in self._base]
        self._last_t = -1

    # -- TopologyModel surface ---------------------------------------------

    @property
    def n(self) -> int:
        return self.spec.n

    @property
    def c(self) -> int:
        return len(self._base)

    @property
    def partition(self) -> List[np.ndarray]:
        """The t=0 membership (what D2S-only algorithms sample over)."""
        return [np.asarray(v) for v in self._base]

    @property
    def cluster_sizes(self) -> List[int]:
        return [len(v) for v in self._base]

    @property
    def stateful(self) -> bool:
        return self.time_correlated or self._recluster > 0

    def sample(self, rng: np.random.Generator, t: int = 0
               ) -> List[ClusterGraph]:
        """One G(t) snapshot: a list of c cluster digraphs.

        Derived from ``sample_sparse`` -- the sparse CSR snapshot is the
        primary representation; densifying it block-by-block reproduces
        the historical dense output bitwise (same rng stream, same edge
        sets)."""
        return [g.dense() for g in self.sample_sparse(rng, t)]

    def sample_sparse(self, rng: np.random.Generator, t: int = 0
                      ) -> List[SparseClusterGraph]:
        """One G(t) snapshot in CSR form (``SparseClusterGraph`` per
        cluster): the scale path -- nothing larger than a cluster block
        is ever densified.  Consumes the rng stream identically to
        ``sample`` (which is derived from this method), so sparse and
        dense plans built from the same seed describe the same
        trajectory."""
        t = int(t)
        if self.stateful:
            if t == 0:
                self._partition = [np.asarray(v) for v in self._base]
                self._reset(rng)
            elif t == self._last_t + 1:
                if self._recluster > 0 and t % self._recluster == 0:
                    self._reshuffle(rng)
                self._advance(rng, t)
            else:
                raise ValueError(
                    f"family {self.spec.family!r} is time-correlated: "
                    f"sample() needs consecutive t = 0, 1, 2, ... "
                    f"(got t={t} after t={self._last_t}); t=0 resets")
        self._last_t = t
        return [self._cluster_sparse(rng, t, np.asarray(verts))
                for verts in self._partition]

    # -- state hooks --------------------------------------------------------

    def _reshuffle(self, rng: np.random.Generator) -> None:
        """Periodic re-clustering: fresh membership, same cluster sizes."""
        perm = rng.permutation(self.n)
        bounds = np.cumsum([len(v) for v in self._base])[:-1]
        self._partition = [np.sort(p) for p in np.split(perm, bounds)]

    def _reset(self, rng: np.random.Generator) -> None:  # pragma: no cover
        pass

    def _advance(self, rng: np.random.Generator, t: int) -> None:
        pass  # pragma: no cover

    def _cluster_W(self, rng: np.random.Generator, t: int,
                   verts: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _cluster_sparse(self, rng: np.random.Generator, t: int,
                        verts: np.ndarray) -> SparseClusterGraph:
        """One cluster's CSR snapshot.  The default converts the dense
        ``_cluster_W`` block -- ``(s, s)`` scratch only, with ``s`` the
        cluster size, so families whose *generative model* is inherently
        pairwise (Erdos-Renyi coin flips, geometric distance tests)
        still produce sparse rows without an O(n^2) global allocation.
        Deterministic families (``ring``, ``hub``) override this with a
        native edge-list construction and derive ``_cluster_W`` the
        other way around."""
        return SparseClusterGraph.from_dense(
            verts, self._cluster_W(rng, t, verts))
