"""The registered control policies (numpy-only copy of
``repro.control.controllers``).

===============  =====================================================
family           policy
===============  =====================================================
``static``       open loop: emit the planner's eq.-7 ``m_rule``
                 verbatim.  A controlled run with ``static``
                 reproduces the precomputed ``connectivity_aware``
                 plan bitwise (the pin the control tests enforce).
``threshold``    closed loop: re-solve the eq.-7 threshold rule each
                 round against the *realized* per-cluster
                 ``exact_phi_ell`` -- not the degree-stat bound the
                 open-loop planner must rely on.  When the bound is
                 loose (hubs, heavy tails), the realized spectrum
                 admits a smaller m: fewer D2S uploads for the same
                 eq.-6 guarantee.  Optional theory-driven eta
                 re-derivation (``mu``/``beta`` > 0) re-evaluates the
                 Thm.-4.5 schedule at the realized connectivity.
``similarity``   learned collaboration graph (Zantedeschi et al.,
                 "Fully Decentralized Joint Learning of Personalized
                 Models and Collaboration Graphs", AISTATS 2020):
                 alternate model steps with graph steps -- after each
                 round, EMA-blend the cosine-similarity Gram matrix of
                 the client deltas and push it into a ``learned``
                 topology (``set_similarity``), whose top-k rule turns
                 it into next round's D2D graph.  m is chosen like
                 ``threshold`` (the learned graph's realized phi).
===============  =====================================================
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import sampling
from repro_torch.core.bounds import psi_total
from repro_torch.core.theory import TheoryConstants, eta_schedule

from .base import Controller, Decision, RealizedRound, register

__all__ = ["Static", "Threshold", "Similarity"]


@register("static")
class Static(Controller):
    """Open-loop reference policy: the planner's decision, unchanged."""

    DEFAULTS: dict = {}
    needs_phi = False

    def observe(self, record, realized: RealizedRound) -> Decision:
        return Decision(m=realized.m_rule)


class _ThresholdBase(Controller):
    """Shared closed-loop m rule: ``min_clients`` on realized phis."""

    def reset(self, network, config) -> None:
        super().reset(network, config)
        pm = float(self._params["phi_max"])
        self._phi_max = pm if pm >= 0.0 else float(config.phi_max)

    def _decide_m(self, realized: RealizedRound) -> int:
        return sampling.min_clients(realized.phis, realized.sizes,
                                    realized.n, self._phi_max)


@register("threshold")
class Threshold(_ThresholdBase):
    """Eq.-7 inverted against realized connectivity, every round.

    ``phi_max < 0`` (the default) inherits ``config.phi_max``.  With
    ``mu``/``beta`` both > 0, each round's eta is re-derived from the
    Thm.-4.5 schedule evaluated at the realized ``psi(m)`` instead of
    the planned ``phi_max`` (rho/delta/gamma enter the *rate* envelope
    but not the schedule, so zeros suffice here).
    """

    DEFAULTS: dict = {"phi_max": -1.0, "tau": 1, "scheme": "all",
                      "mu": 0.0, "beta": 0.0}

    def reset(self, network, config) -> None:
        super().reset(network, config)
        mu, beta = float(self._params["mu"]), float(self._params["beta"])
        self._consts = (
            TheoryConstants(mu=mu, beta=beta, rho=0.0, delta=0.0,
                            gamma=0.0, n=network.n, T=config.T)
            if mu > 0.0 and beta > 0.0 else None)

    def observe(self, record, realized: RealizedRound) -> Decision:
        m = self._decide_m(realized)
        eta = None
        if self._consts is not None:
            psi = float(psi_total(m, realized.n, realized.phis,
                                  realized.sizes))
            eta = float(eta_schedule(self._consts, psi)(realized.t))
        return Decision(m=m, tau=int(self._params["tau"]),
                        scheme=str(self._params["scheme"]), eta=eta)


@register("similarity")
class Similarity(_ThresholdBase):
    """Dada-style alternating optimization of model and graph.

    Requires a topology exposing ``set_similarity`` (the ``learned``
    family).  ``feed`` receives the round's (n, P) client-delta matrix,
    row-normalizes it, and EMA-blends the Gram matrix ``X X^T`` into
    the running similarity estimate ``S``; every ``graph_every`` rounds
    ``S`` is pushed into the topology, whose top-k rule realizes it as
    the next round's collaboration graph.  The resulting run is
    replayable from its emitted plan but *not* regenerable from spec
    (the graph trajectory depends on the training data).
    """

    DEFAULTS: dict = {"phi_max": -1.0, "graph_every": 1, "ema": 0.5,
                      "tau": 1, "scheme": "all"}
    needs_deltas = True

    def reset(self, network, config) -> None:
        super().reset(network, config)
        if not hasattr(network, "set_similarity"):
            raise ValueError(
                "the 'similarity' controller needs a topology exposing "
                "set_similarity (use the 'learned' family), got "
                f"{type(network).__name__}")
        ema = float(self._params["ema"])
        if not 0.0 <= ema < 1.0:
            raise ValueError(f"need 0 <= ema < 1, got {ema}")
        if int(self._params["graph_every"]) < 1:
            raise ValueError("graph_every must be >= 1")
        self._S: np.ndarray = None
        self._rounds_fed = 0

    def observe(self, record, realized: RealizedRound) -> Decision:
        return Decision(m=self._decide_m(realized),
                        tau=int(self._params["tau"]),
                        scheme=str(self._params["scheme"]))

    def feed(self, record, deltas: np.ndarray) -> None:
        X = np.asarray(deltas, np.float64)
        if X.ndim != 2 or X.shape[0] != self._network.n:
            raise ValueError(
                f"deltas must be (n, P) = ({self._network.n}, P), "
                f"got {X.shape}")
        norms = np.linalg.norm(X, axis=1)
        norms[norms == 0.0] = 1.0
        X = X / norms[:, None]
        G = X @ X.T
        ema = float(self._params["ema"])
        self._S = G if self._S is None else ema * self._S + (1.0 - ema) * G
        self._rounds_fed += 1
        if self._rounds_fed % int(self._params["graph_every"]) == 0:
            self._network.set_similarity(self._S)
