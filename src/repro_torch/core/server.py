"""Parameter-server orchestration: plan -> engine -> History (port of
``repro.core.server``).

The server is a thin host-side driver around two objects:

* ``repro_torch.fl.plan.RoundPlan`` -- the full time-varying trajectory
  ``(A_t, tau_t, m_t, eta_t, active_t)`` as stacked host arrays, built by
  the algorithm constructors (``connectivity_aware`` = Algorithm 1 with
  the eq.-7 m(t) rule, ``fedavg`` = A I / fixed m, ``colrel``) and
  serializable to JSON.
* the engine that executes a plan on one device, selected by one
  ``ExecutionConfig`` (``repro_torch.fl.engine.make_engine``): the
  synchronous ``LocalEngine`` (``backend=, scan=, record_mixed=``), the
  semi-async ``repro_torch.fl.stream.StreamEngine`` (``stream=``) or the
  wall-clock ``repro_torch.runtime.IngestEngine`` (``stream=`` and
  ``runtime=``).

Planning and batch sampling draw from SPLIT numpy rng streams, exactly as
in the reference: planning from ``default_rng(config.seed)`` (owned by
the ``RoundPlan`` constructors), batches from ``default_rng([config.seed,
1])`` -- so the same seed gives the same plan and the same batches in
both packages, and a replayed plan consumes the batch stream like the
planning run did.

``run(controller=...)`` closes the loop instead: a ``repro_torch.control``
policy decides each round online (``LocalEngine.execute_controlled``),
and ``last_plan`` then holds the realized plan, which replays the run
bitwise through ``run(plan=...)``.

Not ported: the reference's deprecated per-knob kwargs
(``mixing_backend=``, ``scan_rounds=``, ..., translated there under a
``DeprecationWarning``) -- pass ``execution=ExecutionConfig(...)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .metrics import CommLedger
from .spans import span

__all__ = ["ServerConfig", "RoundRecord", "History", "FederatedServer"]

PyTree = Any
BatchSampler = Callable[[np.random.Generator, int], PyTree]
EvalFn = Callable[[PyTree], Dict[str, float]]
EtaSchedule = Callable[[int], float]

ALGORITHMS = ("semidec", "fedavg", "colrel")


@dataclasses.dataclass
class ServerConfig:
    T: int = 5                      # local SGD iterations per global round
    t_max: int = 30                 # number of global rounds
    phi_max: float = 0.06           # connectivity-factor threshold (Alg. 1 input)
    m0: Optional[int] = None        # initial sample size (default: n)
    m_fixed: Optional[int] = None   # fedavg / colrel sample size
    bound_kind: str = "auto"        # 'regular' (5.1) | 'general' (5.2) | 'auto'
                                    # | 'verbatim' (eq. 6 incl. +1)
                                    # | 'exact' (oracle sigma from topology)
    energy_ratio: float = 0.1       # E_D2D / E_Glob
    seed: int = 0
    eta: EtaSchedule = dataclasses.field(
        default_factory=lambda: (lambda t: 0.02 * (0.1 ** t)))  # paper Sec. 6.1.3


@dataclasses.dataclass
class RoundRecord:
    t: int
    m: int
    m_actual: int
    psi_bound: float      # server's bound on the connectivity factor (eq. 6)
    d2s: int
    d2d: int
    eta: float
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    # streaming telemetry (repro_torch.fl.stream): deadline hits, late /
    # lost / duplicate uploads, staleness stats, weighted divisor,
    # shortfall.  None for every synchronous round, so a fault-free
    # semi-async run records a History identical to the synchronous one.
    stream: Optional[Dict[str, float]] = None
    # control telemetry (repro_torch.control): realized per-cluster phi,
    # the open-loop m rule vs the decided m, gossip depth.  None for every
    # open-loop round AND for replays of a controlled run's emitted plan
    # -- replay equality checks compare everything but this field.
    control: Optional[Dict[str, float]] = None


@dataclasses.dataclass
class History:
    algorithm: str
    records: List[RoundRecord] = dataclasses.field(default_factory=list)
    ledger: CommLedger = dataclasses.field(default_factory=CommLedger)

    def series(self, key: str) -> np.ndarray:
        return np.array([r.metrics.get(key, np.nan) for r in self.records])

    @property
    def sample_sizes(self) -> np.ndarray:
        return np.array([r.m for r in self.records])

    def cumulative_cost(self) -> np.ndarray:
        return self.ledger.cumulative_cost()


class FederatedServer:
    """Runs ``t_max`` global rounds of the chosen algorithm.

    ``network`` is any ``repro_torch.topology`` model.  ``execution`` (a
    ``repro_torch.fl.engine.ExecutionConfig``, default einsum) selects the
    backend; ``device`` the device (``cuda`` unless given -- with no GPU
    and no device this raises).  After ``run()``, ``self.last_plan``
    holds the executed ``RoundPlan``.
    """

    def __init__(self, network, loss_fn, init_params: PyTree,
                 batch_sampler: BatchSampler, config: ServerConfig,
                 algorithm: str = "semidec", execution=None, device=None):
        # deferred: repro_torch.fl.engine imports this module
        from repro_torch.fl.engine import ExecutionConfig, make_engine

        if algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm must be one of {ALGORITHMS}")
        if algorithm in ("fedavg", "colrel") and config.m_fixed is None:
            raise ValueError(f"{algorithm} requires config.m_fixed")
        if execution is None:
            execution = ExecutionConfig()
        self.network = network
        self.config = config
        self.algorithm = algorithm
        self.params = init_params
        self.batch_sampler = batch_sampler
        self.execution = execution
        self.engine = make_engine(execution, loss_fn, device=device)
        # batch stream only; planning owns default_rng(config.seed) so
        # the plan seed embeds and server-built plans regenerate()
        self.rng = np.random.default_rng([config.seed, 1])
        self.last_plan = None

    @property
    def effective_backend(self) -> str:
        """The backend the engine actually dispatches (post
        ``resolve_backend``, e.g. 'fused' upgraded to 'aggregate')."""
        return self.engine.backend

    @property
    def device(self):
        return self.engine.device

    def _plan_and_batches(self, plan=None):
        """Build (or adopt) the trajectory and draw the per-round batches
        (planning on its own seeded stream, batches from ``self.rng``)."""
        from repro_torch.fl.plan import RoundPlan

        cfg = self.config
        if plan is None:
            ctor = {"semidec": RoundPlan.connectivity_aware,
                    "fedavg": RoundPlan.fedavg,
                    "colrel": RoundPlan.colrel}[self.algorithm]
            plan = ctor(self.network, cfg)
        elif plan.n_clients != self.network.n:
            raise ValueError(
                f"plan is for {plan.n_clients} clients, network has "
                f"{self.network.n}")
        with span("repro_torch.batches"):
            batches = [self.batch_sampler(self.rng, t)
                       for t in range(plan.n_rounds)]
        return plan, batches

    def run(self, eval_fn: Optional[EvalFn] = None, eval_every: int = 1,
            plan=None, controller=None) -> History:
        """build plan -> engine.execute(plan) -> History.

        ``plan``: an explicit ``RoundPlan`` to execute (e.g. loaded from
        JSON, or a built plan transformed by ``with_dropout``); default
        is to plan ``config.t_max`` rounds of ``self.algorithm`` here.

        ``controller``: close the loop instead of planning open-loop --
        a ``repro_torch.control`` policy (family string like
        ``'threshold:phi_max=0.2'``, a ``ControllerSpec``, or a built
        ``Controller``) decides each round's sample size / gossip depth
        / step size online from the realized topology.  Mutually
        exclusive with ``plan``; requires an engine with an
        ``execute_controlled`` method (``LocalEngine``,
        ``StreamEngine``).  Afterwards
        ``self.last_plan`` holds the *realized* plan emitted by the
        control loop -- replaying it through ``run(plan=...)`` reproduces
        the controlled run bitwise (modulo the ``RoundRecord.control``
        telemetry, which only the live run has).
        """
        if controller is not None:
            if plan is not None:
                raise ValueError(
                    "pass either plan= or controller=, not both: a "
                    "controller generates its own realized plan")
            if self.algorithm != "semidec":
                raise ValueError(
                    "controllers drive the connectivity-aware algorithm "
                    f"only (algorithm='semidec'), got {self.algorithm!r}")
            execute_controlled = getattr(self.engine,
                                         "execute_controlled", None)
            if execute_controlled is None:
                raise ValueError(
                    f"{type(self.engine).__name__} does not support "
                    "controlled execution (no execute_controlled); use "
                    "LocalEngine")
            from repro_torch.control import ControlLoop

            sparse = self.effective_backend in ("sparse",
                                                "sparse_aggregate")
            loop = ControlLoop(self.network, self.config, controller,
                               algorithm=self.algorithm, sparse=sparse)
            with span("repro_torch.batches"):
                batches = [self.batch_sampler(self.rng, t)
                           for t in range(self.config.t_max)]
            self.params, history = execute_controlled(
                loop, self.params, batches, eval_fn=eval_fn,
                eval_every=eval_every,
                energy_ratio=self.config.energy_ratio)
            self.last_plan = self.engine.last_realized_plan
            return history
        plan, batches = self._plan_and_batches(plan)
        self.params, history = self.engine.execute(
            plan, self.params, batches, eval_fn=eval_fn,
            eval_every=eval_every, energy_ratio=self.config.energy_ratio)
        self.last_plan = plan
        return history
