"""Runtime engine: execute a ``RoundPlan`` and return a ``History``
(single-host port of ``repro.fl.engine``).

    ExecutionConfig   what to run: backend name, scan on/off, mixed-delta
                      recording.
    LocalEngine       single-host runtime over ``repro_torch.core.rounds``
                      (``make_round_fn`` / ``make_scanned_rounds``) on one
                      device -- ``cuda`` unless the caller passes
                      ``device="cpu"``.
    make_engine       ExecutionConfig -> the engine.

Backend selection::

    backends                           record_mixed                 scan
    ---------------------------------  ---------------------------  ----
    einsum | pallas | fused            False upgrades pallas/fused  yes
    | aggregate                        -> 'aggregate'
    sparse | sparse_aggregate          False upgrades sparse ->     yes
                                       'sparse_aggregate'

The sparse backends take any plan: a sparse (CSR) plan's ``A_t`` goes to
the device as (K, n, d_max) ELL columns without densifying, a dense plan
is converted O(nnz)-wise; the dense backends densify a sparse plan.
The reference's mesh, stream (semi-async) and wall-clock runtimes, and
its quantized payloads, raise ``NotImplementedError`` until their slices
of the port (ROADMAP queue 1).

Straggler masks: when ``plan.has_dropout`` the per-round ``active_t``
column is threaded into the round functions; all-ones plans skip the mask
plumbing entirely, so full participation is bitwise-identical to the
mask-free path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.metrics import CommLedger
from repro_torch.core.pytree import tree_map
from repro_torch.core.rounds import (SPARSE_BACKENDS, check_backend,
                                     make_round_fn, make_scanned_rounds)
from repro_torch.core.sparse import SparseAseq
from repro_torch.core.server import History, RoundRecord
from .plan import RoundPlan

__all__ = ["ExecutionConfig", "LocalEngine", "make_engine",
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
    the aggregate-only fast path.  ``mesh``, ``stream`` and ``quant`` are
    the reference's other runtimes and payload formats: setting any of
    them raises until its slice of the port.
    """
    backend: str = "einsum"
    scan: bool = False
    record_mixed: bool = False
    mesh: Any = None
    stream: Any = None
    quant: Any = None


def resolve_backend(cfg: ExecutionConfig) -> str:
    """Validate ``cfg`` and return the *effective* backend name."""
    for field, item in (("mesh", 13), ("stream", 9), ("quant", 8)):
        if getattr(cfg, field) is not None:
            raise NotImplementedError(
                f"ExecutionConfig.{field} is not yet ported to repro_torch "
                f"(ROADMAP queue 1 item {item})")
    check_backend(cfg.backend)
    if cfg.record_mixed and cfg.backend in ("aggregate", "sparse_aggregate"):
        raise ValueError(
            f"record_mixed=True contradicts the {cfg.backend!r} backend, "
            "which never materializes mixed deltas")
    # History never records per-client mixed deltas, so unless the caller
    # explicitly keeps them, the kernel backends take the aggregate-only
    # fast path.
    if not cfg.record_mixed and cfg.backend in ("pallas", "fused"):
        return "aggregate"
    if not cfg.record_mixed and cfg.backend == "sparse":
        return "sparse_aggregate"
    return cfg.backend


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
    matmuls or cuDNN convolutions (cuDNN's default is TF32), and
    deterministic cuDNN algorithms, so a rerun and the scanned driver
    reproduce a run bitwise.  Process-wide; every CUDA ``LocalEngine``
    sets it."""
    torch.backends.cuda.matmul.allow_tf32 = False
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
    fp32 on the card (``set_fp32_policy``)."""

    def __init__(self, loss_fn, cfg: ExecutionConfig, device=None):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.backend = resolve_backend(cfg)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_fp32_policy()

    def execute(self, plan, params, batches, *, eval_fn=None, eval_every=1,
                energy_ratio=0.1):
        """Run every round of ``plan`` from ``params``; ``batches`` is the
        per-round list of batch pytrees.  Params and batches are moved to
        the engine's device.  Returns ``(final_params, History)``."""
        _check_batches(plan, batches)
        K = plan.n_rounds
        device = self.device
        sparse = self.backend in SPARSE_BACKENDS
        A_seq, tau_seq, m_seq, eta_seq, active_seq = _device_columns(
            plan, device, sparse)
        history = History(algorithm=plan.algorithm,
                          ledger=CommLedger(energy_ratio=energy_ratio))
        params = _to_device(params, device)
        batches = [_to_device(b, device) for b in batches]

        if self.cfg.scan:
            scanned = make_scanned_rounds(self.loss_fn, K, self.backend)
            batches_seq = tree_map(lambda *bs: torch.stack(bs), *batches)
            params, params_seq = scanned(params, batches_seq, A_seq,
                                         tau_seq, m_seq, eta_seq,
                                         active_seq)
            for t in range(K):
                _append_record(
                    plan, history, t,
                    lambda tt=t: tree_map(lambda x: x[tt], params_seq),
                    eval_fn, eval_every)
            return params, history

        round_fn = make_round_fn(self.loss_fn, self.backend)
        for t in range(K):
            active = active_seq[t] if active_seq is not None else None
            A = (A_seq[0][t], A_seq[1][t]) if sparse else A_seq[t]
            params, _ = round_fn(params, batches[t], A, tau_seq[t],
                                 m_seq[t], eta_seq[t], active)
            # record inline: only the current round's params stay live
            _append_record(plan, history, t, lambda p=params: p,
                           eval_fn, eval_every)
        return params, history


def make_engine(cfg: ExecutionConfig, loss_fn=None, device=None
                ) -> LocalEngine:
    """ExecutionConfig -> the engine that implements it (the single-host
    ``LocalEngine``; the mesh and stream engines raise until their
    slices)."""
    return LocalEngine(loss_fn, cfg, device=device)
