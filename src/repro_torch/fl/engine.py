"""Runtime engine: execute a ``RoundPlan`` and return a ``History``
(single-host port of ``repro.fl.engine``).

    ExecutionConfig   what to run: backend name, scan on/off, mixed-delta
                      recording, payload quantization, and the semi-async
                      (``stream``) and wall-clock (``runtime``) runtimes.
    LocalEngine       single-host runtime over ``repro_torch.core.rounds``
                      (``make_round_fn`` / ``make_scanned_rounds``) on one
                      device -- ``cuda`` unless the caller passes
                      ``device="cpu"``; ``execute`` runs a plan,
                      ``execute_controlled`` a ``repro_torch.control``
                      loop (the closed loop, one round at a time).
    MeshEngine        the mesh runtime over ``repro_torch.fl.distributed``
                      (``make_train_step`` / ``make_scanned_train_steps``):
                      one client a rank of a ``torch.distributed`` mesh
                      (``mesh`` and ``model_cfg``).
    make_engine       ExecutionConfig -> the engine: ``LocalEngine``,
                      ``MeshEngine`` (``mesh``),
                      ``repro_torch.fl.stream.StreamEngine`` (``stream``)
                      or ``repro_torch.runtime.IngestEngine`` (``stream``
                      and ``runtime``).

Backend selection::

    runtime      backends                   record_mixed             scan
    -----------  -------------------------  -----------------------  ----
    LocalEngine  einsum | pallas | fused    False upgrades           yes
                 | aggregate                pallas/fused ->
                                            'aggregate'
                 sparse | sparse_aggregate  False upgrades sparse    yes
                                            -> 'sparse_aggregate'
    MeshEngine   ring | gather | einsum     unsupported              yes
                 | fused | fused_rs

The sparse backends take any plan: a sparse (CSR) plan's ``A_t`` goes to
the device as (K, n, d_max) ELL columns without densifying, a dense plan
is converted O(nnz)-wise; the dense backends densify a sparse plan.
The stream runtime (``ExecutionConfig.stream``, a ``StreamConfig``) takes
the dense backends only: 'pallas' and 'fused' resolve to 'aggregate'
(stale cohorts aggregate through combine rows), and quant, scan,
record_mixed and the sparse backends are refused, as is ``runtime``
without ``stream``.  The mesh runtime needs ``model_cfg`` (its steps
train ``Model(model_cfg).loss``; the server's ``loss_fn`` is unused) and
takes per-round token arrays ``(n, T, B_local, S+1)`` as its batches; at
a 'model' axis above 1 each rank trains its tensor-parallel shards, for
every family of the zoo.

Quantized payloads: ``ExecutionConfig.quant`` (or, when it is None, the
plan's ``quant``) quantizes every client upload (``QuantSpec``); the
*effective* backend must be one of ``QUANT_BACKENDS`` ('fused' /
'fused_rs' on the mesh), so 'fused' that upgraded to 'aggregate'
quantizes while 'pallas' kept by ``record_mixed`` is rejected.  Both
drivers thread the quantizer state from round to round.

Straggler masks: when ``plan.has_dropout`` the per-round ``active_t``
column is threaded into the round functions; all-ones plans skip the mask
plumbing entirely, so full participation is bitwise-identical to the
mask-free path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.metrics import CommLedger
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.core.rounds import (SPARSE_BACKENDS, check_backend,
                                     check_quant_backend, client_deltas,
                                     make_round_fn, make_scanned_rounds)
from repro_torch.core.sparse import SparseAseq
from repro_torch.core.server import History, RoundRecord
from repro_torch.core.spans import span
from . import packing
from .plan import RoundPlan, _check_quant_type

__all__ = ["ExecutionConfig", "LocalEngine", "MeshEngine", "make_engine",
           "resolve_backend", "resolve_device", "set_fp32_policy"]

PyTree = Any
EvalFn = Callable[[PyTree], Dict[str, float]]


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """How to execute a plan.

    ``backend`` names a single-host mixing backend
    (``repro_torch.core.rounds.MIXING_BACKENDS``).
    ``scan=True`` runs the whole K-round trajectory from stacked columns
    (``make_scanned_rounds``).  ``record_mixed=True`` keeps per-client
    mixed deltas materialized; otherwise the kernel backends upgrade to
    the aggregate-only fast path.  ``quant`` (a ``packing.QuantSpec``)
    quantizes the client payloads and overrides the plan's.  ``stream``
    (a ``repro_torch.fl.stream.StreamConfig``) selects the event-driven
    semi-async runtime instead of the synchronous one; ``runtime`` (a
    ``repro_torch.runtime.RuntimeConfig``, requires ``stream``) upgrades
    it to the wall-clock ingestion engine.  ``mesh`` (a ``DeviceMesh``,
    ``repro_torch.launch.mesh.make_debug_mesh``) with ``model_cfg``
    selects the mesh runtime, whose ``backend`` is one of
    ``repro_torch.fl.distributed.MIXINGS``.
    """
    backend: str = "einsum"
    scan: bool = False
    record_mixed: bool = False
    mesh: Any = None
    model_cfg: Any = None
    stream: Any = None
    quant: Any = None
    runtime: Any = None


def resolve_backend(cfg: ExecutionConfig) -> str:
    """Validate ``cfg`` and return the *effective* backend name: the
    stream matrix, the record_mixed upgrade to 'aggregate', and every
    invalid combination."""
    if cfg.runtime is not None and cfg.stream is None:
        raise ValueError(
            "cfg.runtime (the wall-clock ingestion engine) extends the "
            "semi-async runtime; it requires cfg.stream (a StreamConfig) "
            "for the closure policy")
    if cfg.stream is not None:
        return _resolve_stream_backend(cfg)
    if cfg.mesh is not None:
        return _resolve_mesh_backend(cfg)
    check_backend(cfg.backend)
    if cfg.record_mixed and cfg.backend in ("aggregate", "sparse_aggregate"):
        raise ValueError(
            f"record_mixed=True contradicts the {cfg.backend!r} backend, "
            "which never materializes mixed deltas")
    # History never records per-client mixed deltas, so unless the caller
    # explicitly keeps them, the kernel backends take the aggregate-only
    # fast path.
    effective = cfg.backend
    if not cfg.record_mixed and cfg.backend in ("pallas", "fused"):
        effective = "aggregate"
    if not cfg.record_mixed and cfg.backend == "sparse":
        effective = "sparse_aggregate"
    _check_quant_backend(cfg.quant, effective)
    return effective


def _resolve_stream_backend(cfg: ExecutionConfig) -> str:
    """The stream runtime's part of the matrix (``resolve_backend``)."""
    if cfg.mesh is not None:
        raise ValueError("the stream runtime is single-host; "
                         "cfg.mesh is unsupported with cfg.stream")
    if cfg.quant is not None:
        raise ValueError(
            "quantized payloads are not supported on the stream "
            "runtime: stale cohorts re-aggregate deltas from "
            "earlier rounds, which has no well-defined "
            "error-feedback residual; use LocalEngine")
    if cfg.scan:
        raise ValueError(
            "scan=True contradicts the stream runtime: round closure "
            "is an event-driven host loop, not a scanned trajectory")
    if cfg.record_mixed:
        raise ValueError(
            "record_mixed is not supported on the stream runtime: "
            "stale cohorts aggregate through combine rows and never "
            "materialize mixed deltas")
    check_backend(cfg.backend)
    if cfg.backend in SPARSE_BACKENDS:
        raise ValueError(
            "the sparse backends are not supported on the stream "
            "runtime: cohort closure slices dense A_t rows; use "
            "LocalEngine (backend='sparse') or densify the plan")
    # stale cohorts always take the aggregate-only combine-row path
    if cfg.backend in ("pallas", "fused"):
        return "aggregate"
    return cfg.backend


def _resolve_mesh_backend(cfg: ExecutionConfig) -> str:
    """The mesh runtime's part of the matrix (``resolve_backend``)."""
    from .distributed import MIXINGS

    if cfg.model_cfg is None:
        raise ValueError("mesh runtime requires model_cfg")
    if cfg.backend not in MIXINGS:
        raise ValueError(f"mesh mixing must be one of {MIXINGS}")
    if cfg.record_mixed:
        raise ValueError(
            "record_mixed is not supported on the mesh runtime: "
            "the mesh train step never returns mixed deltas")
    if cfg.quant is not None:
        _check_quant_type(cfg.quant)
        if cfg.backend not in ("fused", "fused_rs"):
            raise ValueError(
                "quantized payloads on the mesh runtime require the "
                f"one-pass 'fused' or 'fused_rs' schedules, got "
                f"{cfg.backend!r}")
    return cfg.backend


def _check_quant_backend(quant, backend: str) -> None:
    """A quant config must be a ``QuantSpec`` and the *effective* backend
    one of ``QUANT_BACKENDS``: 'pallas' kept alive by record_mixed is
    rejected (its leaf-wise kernels have no packed buffers to attach
    scales to)."""
    if quant is None:
        return
    _check_quant_type(quant)
    check_quant_backend(backend)


def _quant_setup(cfg: ExecutionConfig, plan: RoundPlan, params: PyTree,
                 backend: str, device: torch.device):
    """The effective quant config (cfg overrides plan) and the round-0
    quantizer state on ``device``.  The packing spec reads only leaf
    shapes and dtypes, so it is built from ``meta`` tensors of the delta
    tree (deltas share the param tree's structure and dtypes) -- the same
    cache entry the round functions hit.  ``(None, None)`` when neither
    source quantizes."""
    quant = cfg.quant if cfg.quant is not None else plan.quant
    if quant is None:
        return None, None
    _check_quant_backend(quant, backend)
    n = plan.n_clients
    spec = packing.pack_spec(
        tree_map(lambda p: torch.empty((n,) + tuple(p.shape),
                                       dtype=p.dtype, device="meta"),
                 params), quant=quant)
    return quant, packing.init_quant_state(spec, n, device)


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``; with no device given and no
    GPU present this raises -- it never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the GPU by default; pass "
            "device='cpu' explicitly to run on the CPU")
    return torch.device("cuda")


def set_fp32_policy() -> None:
    """Full fp32 on the card, as the reference computes: no TF32 in
    matmuls or cuDNN convolutions (cuDNN's default is TF32), bf16 matmuls
    reduced in fp32 (cuBLAS may otherwise reduce split-K partial sums in
    bf16; the reference accumulates bf16 products in fp32), and
    deterministic cuDNN algorithms, so a rerun and the scanned driver
    reproduce a run bitwise.  Process-wide; every CUDA ``LocalEngine``
    and every CUDA ``models.model.Model`` sets it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _device_columns(plan: RoundPlan, device: torch.device,
                    sparse: bool = False):
    """Plan columns as stacked tensors on ``device`` (the scanned driver's
    inputs; the sequential driver indexes into the same tensors, which
    keeps the per-round values identical).

    ``sparse=True`` (the ELL backends) gives ``A_seq`` as the pair
    ``(idx_seq, w_seq)`` of (K, n, d_max) int32 / fp32 tensors -- straight
    from a sparse plan without densifying, converted O(nnz)-wise from a
    dense one.  Dense backends on a sparse plan densify it (small-n
    parity testing; at scale keep representation and backend aligned).
    """
    def col(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    if sparse:
        A = plan.A_t if plan.is_sparse else SparseAseq.from_dense(plan.A_t)
        idx_seq, w_seq = A.ell()
        if idx_seq.size and not (0 <= idx_seq.min()
                                 and idx_seq.max() < plan.n_clients):
            raise ValueError("ELL neighbour ids outside [0, n)")
        A_seq = (torch.as_tensor(idx_seq, dtype=torch.int32, device=device),
                 col(w_seq))
    else:
        A_seq = col(plan.A_t.dense() if plan.is_sparse else plan.A_t)
    active_seq = col(plan.active_t) if plan.has_dropout else None
    return (A_seq, col(plan.tau_t), col(plan.m_t), col(plan.eta_t),
            active_seq)


def _to_device(tree: PyTree, device: torch.device) -> PyTree:
    return tree_map(lambda x: torch.as_tensor(x).to(device), tree)


def _record(plan: RoundPlan, t: int) -> RoundRecord:
    # t is local to the plan; plan.t0 shifts sliced (resumed) plans so
    # History round indices stay global across a crash/restore boundary
    return RoundRecord(
        t=plan.t0 + t, m=int(plan.m_planned_t[t]),
        m_actual=int(plan.m_actual_t[t]),
        psi_bound=float(plan.psi_bound_t[t]), d2s=int(plan.d2s_t[t]),
        d2d=int(plan.d2d_t[t]), eta=float(plan.eta_t[t]))


def _check_batches(plan: RoundPlan, batches) -> None:
    if len(batches) != plan.n_rounds:
        raise ValueError(
            f"need one batch entry per plan round: plan has "
            f"{plan.n_rounds} rounds, got {len(batches)} batches")


def _append_record(plan: RoundPlan, history: History, t: int, get_params,
                   eval_fn: Optional[EvalFn], eval_every: int) -> None:
    """One ``RoundRecord`` (+ ledger row) for round ``t``;
    ``get_params()`` yields the post-round globals, called only on the
    eval cadence."""
    rec = _record(plan, t)
    if eval_fn is not None and (t % eval_every == 0
                                or t == plan.n_rounds - 1):
        rec.metrics = {k: float(v)
                       for k, v in eval_fn(get_params()).items()}
    history.records.append(rec)
    history.ledger.add_round(d2s=rec.d2s, d2d=rec.d2d)


class LocalEngine:
    """Single-host runtime: ``repro_torch.core.rounds`` round functions
    on ``device`` (``cuda`` unless given; ``resolve_device``), in full
    fp32 on the card (``set_fp32_policy``).

    ``staged_bytes`` only grows: both execute paths add the ``nbytes`` of
    every tensor they move to the device from the host (plan columns,
    params, batches; the quantizer state is made on the device and
    moves nothing).  Read it as a difference around a run."""

    def __init__(self, loss_fn, cfg: ExecutionConfig, device=None):
        if cfg.mesh is not None:
            raise ValueError("LocalEngine does not take a mesh; use "
                             "MeshEngine (or make_engine)")
        if cfg.stream is not None:
            raise ValueError("LocalEngine is synchronous; use "
                             "StreamEngine (or make_engine) for "
                             "cfg.stream")
        self.cfg = cfg
        self.backend = resolve_backend(cfg)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_fp32_policy()
        if loss_fn is None and cfg.model_cfg is not None:
            # an LM plan: the loss of the configured model on this device
            from repro_torch.models.model import Model
            loss_fn = Model(cfg.model_cfg, device=self.device).loss
        self.loss_fn = loss_fn
        # filled by execute_controlled: the realized RoundPlan artifact
        self.last_realized_plan = None
        self.staged_bytes = 0

    def _stage(self, tree: PyTree) -> PyTree:
        """``tree`` on the engine's device; the bytes of each leaf that
        had to move there are added to ``staged_bytes``."""
        def move(x):
            x = torch.as_tensor(x)
            y = x.to(self.device)
            if y is not x:
                self.staged_bytes += y.nbytes
            return y

        return tree_map(move, tree)

    def execute(self, plan, params, batches, *, eval_fn=None, eval_every=1,
                energy_ratio=0.1):
        """Run every round of ``plan`` from ``params``; ``batches`` is the
        per-round list of batch pytrees.  Params and batches are moved to
        the engine's device.  Returns ``(final_params, History)``."""
        _check_batches(plan, batches)
        K = plan.n_rounds
        device = self.device
        sparse = self.backend in SPARSE_BACKENDS
        with span("repro_torch.stage"):
            # the columns built on the host, then moved like the batches
            cols = self._stage(_device_columns(plan, torch.device("cpu"),
                                               sparse))
            params = self._stage(params)
            batches = [self._stage(b) for b in batches]
            quant, qstate = _quant_setup(self.cfg, plan, params,
                                         self.backend, device)
        A_seq, tau_seq, m_seq, eta_seq, active_seq = cols
        history = History(algorithm=plan.algorithm,
                          ledger=CommLedger(energy_ratio=energy_ratio))
        qargs = () if quant is None else (qstate,)

        if self.cfg.scan:
            scanned = make_scanned_rounds(self.loss_fn, K, self.backend,
                                          quant=quant)
            batches_seq = tree_map(lambda *bs: torch.stack(bs), *batches)
            params, params_seq = scanned(params, batches_seq, A_seq,
                                         tau_seq, m_seq, eta_seq,
                                         active_seq, *qargs)[:2]
            for t in range(K):
                _append_record(
                    plan, history, t,
                    lambda tt=t: tree_map(lambda x: x[tt], params_seq),
                    eval_fn, eval_every)
            return params, history

        round_fn = make_round_fn(self.loss_fn, self.backend, quant=quant)
        for t in range(K):
            active = active_seq[t] if active_seq is not None else None
            A = (A_seq[0][t], A_seq[1][t]) if sparse else A_seq[t]
            out = round_fn(params, batches[t], A, tau_seq[t], m_seq[t],
                           eta_seq[t], active, *qargs)
            params, qargs = out[0], out[2:]   # quantized: (new qstate,)
            del out   # the round's mixed deltas, freed before the next
            # record inline: only the current round's params stay live
            _append_record(plan, history, t, lambda p=params: p,
                           eval_fn, eval_every)
        return params, history

    def execute_controlled(self, loop, params, batches, *, eval_fn=None,
                           eval_every=1, energy_ratio=0.1):
        """Closed-loop execution: one ``repro_torch.control.ControlLoop``
        row per round, realized through the same round function as
        ``execute`` with per-round tensors carrying identical values -- so
        replaying ``self.last_realized_plan`` (set on return)
        through ``execute`` reproduces this run bitwise (the replay's
        records merely lack the live ``control`` telemetry).  On the
        sparse backends a live round's ELL is as wide as its own widest
        row, the replay's as the plan's: the extra slots are index 0,
        weight 0.0, which the kernels add as exact zeros on either route.
        (Were the plan's widest row past the staged route's 64 slots and
        a live round's within them, that round would replay on the
        generic route, whose aggregate sums the rows in another order.)

        When the policy consumes training feedback
        (``loop.needs_deltas``, the learned-graph path), each round's
        client deltas are re-derived from the pre-round params, flattened
        leaf by leaf in ``tree_leaves`` order into one host (n, P) fp32
        array and fed back after the round -- one extra deltas evaluation
        and one device-to-host copy per round, the documented price of
        the alternating model/graph scheme.
        """
        cfg = self.cfg
        if cfg.scan:
            raise ValueError(
                "controlled execution is inherently per-round (the "
                "policy observes each realized topology); scan=True is "
                "unsupported")
        if cfg.quant is not None:
            raise ValueError(
                "controlled execution does not support quantized "
                "payloads: the realized plan carries no quant spec to "
                "replay the error-feedback residuals against")
        sparse = self.backend in SPARSE_BACKENDS
        if bool(getattr(loop, "_sparse")) != sparse:
            raise ValueError(
                f"loop sparsity ({getattr(loop, '_sparse')}) must match "
                f"the engine backend {self.backend!r} ({sparse})")
        K = len(batches)
        history = History(algorithm=loop.algorithm,
                          ledger=CommLedger(energy_ratio=energy_ratio))
        with span("repro_torch.stage"):
            params = self._stage(params)
            batches = [self._stage(b) for b in batches]
        round_fn = make_round_fn(self.loss_fn, self.backend)

        def col(a):
            return self._stage(torch.as_tensor(np.asarray(a),
                                               dtype=torch.float32))

        for t in range(K):
            row, telemetry = loop.next_row()
            eta = col(row.eta)
            deltas = None
            if loop.needs_deltas:
                # pre-round params: the deltas the round itself mixes
                tree = client_deltas(self.loss_fn, params, batches[t], eta)
                deltas = np.concatenate(
                    [leaf.reshape(loop.n, -1).cpu().numpy()
                     for leaf in tree_leaves(tree)], axis=1)
                del tree
            if sparse:
                idx, w = row.A.ell()
                A = (self._stage(torch.as_tensor(idx, dtype=torch.int32)),
                     col(w))
            else:
                A = col(row.A)
            params = round_fn(params, batches[t], A, col(row.tau),
                              col(row.m), eta)[0]
            rec = RoundRecord(
                t=row.t, m=row.m_planned, m_actual=row.m_actual,
                psi_bound=row.psi_bound, d2s=row.d2s, d2d=row.d2d,
                eta=row.eta, control=telemetry)
            if eval_fn is not None and (t % eval_every == 0 or t == K - 1):
                rec.metrics = {k: float(v)
                               for k, v in eval_fn(params).items()}
            history.records.append(rec)
            history.ledger.add_round(d2s=rec.d2s, d2d=rec.d2d)
            loop.feed(rec, deltas)
        self.last_realized_plan = loop.emit_plan()
        return params, history


class MeshEngine:
    """Mesh runtime: ``repro_torch.fl.distributed`` train steps on this
    rank of ``cfg.mesh`` (its device: the CPU on gloo, the rank's card on
    NCCL).  ``batches`` entries are per-round token arrays
    ``(n_clients, T, B_local, S+1)``; every rank executes the same plan
    on its shards of the params (``distributed.shard_params``: the whole
    tree at a 'model' axis of 1) and returns the same whole params and
    History (``gather_params``, also for ``eval_fn``)."""

    def __init__(self, cfg: ExecutionConfig):
        from .distributed import mesh_device

        if cfg.mesh is None:
            raise ValueError("MeshEngine requires cfg.mesh")
        if cfg.stream is not None:
            raise ValueError("MeshEngine is synchronous; cfg.stream is "
                             "unsupported on the mesh runtime")
        self.cfg = cfg
        self.backend = resolve_backend(cfg)
        self.device = mesh_device(cfg.mesh)

    def execute(self, plan, params, batches, *, eval_fn=None, eval_every=1,
                energy_ratio=0.1):
        from .distributed import (gather_params, init_rank_quant_state,
                                  make_scanned_train_steps, make_train_step,
                                  shard_params)

        _check_batches(plan, batches)
        cfg, K, device = self.cfg, plan.n_rounds, self.device
        A_seq, tau_seq, m_seq, eta_seq, active_seq = _device_columns(
            plan, device)
        history = History(algorithm=plan.algorithm,
                          ledger=CommLedger(energy_ratio=energy_ratio))
        params = shard_params(_to_device(params, device), cfg.model_cfg,
                              cfg.mesh)

        def whole(p):
            return gather_params(p, cfg.model_cfg, cfg.mesh)

        batches = [_to_device(b, device) for b in batches]
        quant = cfg.quant if cfg.quant is not None else plan.quant
        qstate = None
        if quant is not None:
            _check_quant_type(quant)
            qstate = init_rank_quant_state(params, quant, cfg.mesh,
                                           self.backend)

        if cfg.scan:
            scanned = make_scanned_train_steps(
                cfg.model_cfg, cfg.mesh, K, mixing=self.backend,
                quant=quant)
            out = scanned(params, torch.stack(batches), A_seq, tau_seq,
                          m_seq, eta_seq, active_seq=active_seq,
                          qstate=qstate)
            params, params_seq = out[0], out[1]
            for t in range(K):
                _append_record(
                    plan, history, t,
                    lambda tt=t: whole(tree_map(lambda x: x[tt],
                                                params_seq)),
                    eval_fn, eval_every)
            return whole(params), history

        step = make_train_step(cfg.model_cfg, cfg.mesh,
                               mixing=self.backend, quant=quant)
        for t in range(K):
            active = None if active_seq is None else active_seq[t]
            out = step(params, batches[t], A_seq[t], tau_seq[t], m_seq[t],
                       eta_seq[t], active=active, qstate=qstate)
            params, qstate = out if quant is not None else (out, None)
            _append_record(plan, history, t, lambda p=params: whole(p),
                           eval_fn, eval_every)
        return whole(params), history


def make_engine(cfg: ExecutionConfig, loss_fn=None, device=None):
    """ExecutionConfig -> the engine that implements it on ``device``:
    ``IngestEngine`` (``stream`` and ``runtime``), ``StreamEngine``
    (``stream``), ``MeshEngine`` (``mesh``: the mesh decides its device, and
    ``device`` is not used) or ``LocalEngine``."""
    if cfg.stream is not None:
        # deferred: both import back into this module
        if cfg.runtime is not None:
            from repro_torch.runtime import IngestEngine
            return IngestEngine(loss_fn, cfg, device=device)
        from .stream import StreamEngine
        return StreamEngine(loss_fn, cfg, device=device)
    if cfg.mesh is not None:
        return MeshEngine(cfg)
    return LocalEngine(loss_fn, cfg, device=device)
