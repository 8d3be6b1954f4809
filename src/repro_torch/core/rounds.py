"""Round functions for Algorithm 1 (single-host runtime; port of
``repro.core.rounds``).

One *global aggregation round* exactly as in the paper, batched over
clients with ``torch.func.vmap``:

    1. every client runs ``T`` local SGD iterations from the global model
       (eq. 1, Alg. 1 lines 2-5) -- ``torch.func.grad`` of the loss,
       vmapped over the client axis;
    2. clients exchange scaled cumulative gradients and compute the
       equal-neighbor weighted sums ``Delta = A @ X_diff`` (eq. 2-3);
    3. the PS aggregates the sampled deltas
       ``x <- x + (1/m) sum_i tau_i Delta_i`` (eq. 4).

``A``, ``tau``, ``m``, ``eta`` are tensors on the round's device, so one
round function serves every round of all three algorithms (Alg. 1, FedAvg
via ``A = I``, COLREL via fixed ``m``).

Steps 2+3 come in interchangeable backends (``make_round_fn(...,
mixing_backend=...)``):

  'einsum'    -- leaf-wise plain PyTorch (``mix_deltas`` +
                 ``global_update``, fp32 accumulation); the oracle.
  'pallas'    -- leaf-wise mixing kernel (``ops.mix_pytree``: one
                 ``mix_cuda`` launch per leaf) + the plain aggregate.  The
                 name is the reference's; the kernel is CUDA.
  'fused'     -- packed one-pass path: per-dtype (n, P_pad_g) buffers
                 (``repro_torch.fl.packing``) through ``mix_aggregate_cuda``
                 once per group, emitting mixed deltas and aggregate rows.
  'aggregate' -- the same packed buffers through ``aggregate_cuda``: only
                 ``((tau^T A)/m) @ X_g`` is computed, the mixed deltas are
                 never materialized and the round returns ``None`` in
                 their place.
  'sparse' / 'sparse_aggregate' -- the ELL (neighbour-list) backends:
                 ``A`` arrives as the pair ``(idx, w)`` of (n, d_max)
                 tensors (``repro_torch.core.sparse.SparseA.ell()``)
                 instead of an (n, n) matrix.  'sparse' runs eq. 3 + eq. 4
                 through ``sparse_mix_aggregate_cuda`` once per dtype
                 group; 'sparse_aggregate' builds the combine row by a
                 segment sum over the entries and runs ``aggregate_cuda``,
                 returning ``None`` for the mixed deltas.  O(n d_max p)
                 work and O(n d_max) topology storage: the only backends
                 that scale n past the dense O(n^2) wall.  allclose (not
                 bitwise) to 'einsum'.

Quantized payloads raise ``NotImplementedError`` until their slice of the
port (ROADMAP queue 1 item 8).

``make_scanned_rounds`` runs K rounds as a Python loop over stacked
``(A_t, tau_t, m_t, eta_t[, active_t])`` columns (the sparse backends take
``A_seq = (idx_seq, w_seq)`` of (K, n, d_max) tensors); it executes the
same round function as the sequential driver, so the two are bitwise
equal.

Straggler masks: every round function takes an optional ``active`` (n,)
0/1 mask.  A dropped client contributes zero delta to its D2D neighbors
and never uploads; ``m`` must then be the effective sampled-and-active
count.  The one-pass backends fold the mask into the combine row
(``kernels.mixing.ops.combine_weights``); an all-ones mask is
bitwise-identical to ``active=None``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
from torch.func import grad, vmap

from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.fl import packing
from repro_torch.kernels.mixing.ops import (
    aggregate_grouped, mix_aggregate_grouped, mix_pytree,
    sparse_aggregate_grouped, sparse_mix_aggregate_grouped)

__all__ = [
    "local_sgd",
    "client_deltas",
    "mix_deltas",
    "global_update",
    "fused_mix_update",
    "mask_clients",
    "make_round_fn",
    "make_scanned_rounds",
    "check_backend",
    "MIXING_BACKENDS",
    "SPARSE_BACKENDS",
]

PyTree = Any
LossFn = Callable[[PyTree, PyTree], torch.Tensor]  # (params, batch) -> scalar

MIXING_BACKENDS = ("einsum", "pallas", "fused", "aggregate", "sparse",
                   "sparse_aggregate")
SPARSE_BACKENDS = ("sparse", "sparse_aggregate")


def check_backend(mixing_backend: str) -> None:
    """Raise unless ``mixing_backend`` is one this port runs."""
    if mixing_backend not in MIXING_BACKENDS:
        raise ValueError(
            f"mixing_backend must be one of {MIXING_BACKENDS}, "
            f"got {mixing_backend!r}")


def local_sgd(loss_fn: LossFn, params: PyTree, batches: PyTree,
              eta: torch.Tensor) -> PyTree:
    """T local SGD iterations (eq. 1).  ``batches`` leaves have leading
    axis T."""
    grad_fn = grad(loss_fn)
    for t in range(tree_leaves(batches)[0].shape[0]):
        g = grad_fn(params, tree_map(lambda b: b[t], batches))
        # keep each leaf at its own dtype: the step is taken in fp32
        # (eta is fp32) and cast back, so bf16 params never promote
        params = tree_map(lambda x, gg: (x.float() - eta * gg.float())
                          .to(x.dtype), params, g)
    return params


def client_deltas(loss_fn: LossFn, global_params: PyTree,
                  client_batches: PyTree, eta: torch.Tensor) -> PyTree:
    """Per-client scaled cumulative gradients
    ``x_i^{(t,T)} - x^{(t)} = -eta * sum_k grad f_i(x_i^{(t,k)})``.

    ``client_batches`` leaves: (n_clients, T, ...).  Returns leaves with
    leading axis n_clients.  The clients are batched with
    ``torch.func.vmap`` (convolution, pooling, log-softmax and gather all
    have batching rules, so no per-client loop is needed)."""
    finals = vmap(lambda b: local_sgd(loss_fn, global_params, b, eta))(
        client_batches)
    return tree_map(lambda f, g: f - g[None], finals, global_params)


def mask_clients(tree: PyTree, active: torch.Tensor) -> PyTree:
    """Zero dropped clients' rows: each leaf has leading client axis n and
    is multiplied by the (n,) 0/1 ``active`` mask (cast to the leaf dtype
    so nothing promotes).  An all-ones mask is a bitwise no-op."""
    def one(d):
        shape = (active.shape[0],) + (1,) * (d.ndim - 1)
        return d * active.to(d.dtype).reshape(shape)

    return tree_map(one, tree)


def mix_deltas(A: torch.Tensor, deltas: PyTree) -> PyTree:
    """D2D intra-cluster aggregation ``Delta = A @ X_diff`` (eq. 3),
    leaf-wise over the flattened trailing dims, accumulating in fp32
    whatever the delta dtype (the oracle for the kernel backends)."""
    def mix(d):
        flat = d.reshape(d.shape[0], -1)
        out = A.float() @ flat.float()
        return out.reshape(d.shape).to(d.dtype)

    return tree_map(mix, deltas)


def global_update(global_params: PyTree, mixed: PyTree, tau: torch.Tensor,
                  m: torch.Tensor) -> PyTree:
    """PS aggregation (eq. 4): ``x + (1/m) sum_i tau_i Delta_i``, fp32
    accumulation, cast back to the global-param dtype after the add."""
    def upd(g, d):
        flat = d.reshape(d.shape[0], -1)
        agg = (tau.float() @ flat.float()) / m
        return (g + agg.reshape(g.shape)).to(g.dtype)

    return tree_map(upd, global_params, mixed)


def fused_mix_update(global_params: PyTree, deltas: PyTree, A: torch.Tensor,
                     tau: torch.Tensor, m: torch.Tensor, *,
                     active: Optional[torch.Tensor] = None
                     ) -> Tuple[PyTree, PyTree]:
    """One-pass eq. 3 + eq. 4 over the packed delta buffers: one
    ``mix_aggregate_cuda`` launch per dtype group.  Returns
    ``(new_global_params, mixed_deltas)``.  With a straggler mask the
    packed buffers are masked before the launch so the *mixed* output
    also reflects the drop."""
    spec = packing.pack_spec(deltas)
    bufs = packing.pack(deltas, spec)
    if active is not None:
        bufs = tuple(mask_clients(list(bufs), active))
    mixed_bufs, agg_rows = mix_aggregate_grouped(A, tau, m, bufs,
                                                 active=active)
    mixed = packing.unpack(mixed_bufs, spec)
    new_global = packing.apply_aggregate_row(global_params, agg_rows, spec)
    return new_global, mixed


def _mix_and_update(global_params, deltas, A, tau, m, *, mixing_backend,
                    active=None):
    if mixing_backend in ("einsum", "pallas"):
        # materializing backends: a dropped client's delta is zeroed
        # before eq. 3 and its upload removed from the eq.-4 sum.
        if active is not None:
            deltas = mask_clients(deltas, active)
            tau = tau * active
        if mixing_backend == "einsum":
            mixed = mix_deltas(A, deltas)
        else:
            mixed = mix_pytree(A, deltas)
        return global_update(global_params, mixed, tau, m), mixed
    if mixing_backend == "fused":
        return fused_mix_update(global_params, deltas, A, tau, m,
                                active=active)
    if mixing_backend == "aggregate":
        # one-pass path: the mask folds into the combine row
        # (combine_weights) -- the payload itself is never touched.
        spec = packing.pack_spec(deltas)
        bufs = packing.pack(deltas, spec)
        agg_rows = aggregate_grouped(A, tau, m, bufs, active=active)
        return packing.apply_aggregate_row(global_params, agg_rows,
                                           spec), None
    if mixing_backend in SPARSE_BACKENDS:
        idx, w = A      # ELL pair (n, d_max), never an (n, n) matrix
        spec = packing.pack_spec(deltas)
        bufs = packing.pack(deltas, spec)
        if mixing_backend == "sparse_aggregate":
            agg_rows = sparse_aggregate_grouped(idx, w, tau, m, bufs,
                                                active=active)
            return packing.apply_aggregate_row(global_params, agg_rows,
                                               spec), None
        # the mixed leg streams the payload as given: zero dropped rows
        if active is not None:
            bufs = tuple(mask_clients(list(bufs), active))
        mixed_bufs, agg_rows = sparse_mix_aggregate_grouped(
            idx, w, tau, m, bufs, active=active)
        return (packing.apply_aggregate_row(global_params, agg_rows, spec),
                packing.unpack(mixed_bufs, spec))
    check_backend(mixing_backend)
    raise AssertionError(mixing_backend)   # pragma: no cover


def make_round_fn(loss_fn: LossFn, mixing_backend: str = "einsum", *,
                  quant=None):
    """Build the global-round function.

    Signature: ``round_fn(global_params, client_batches, A, tau, m, eta[,
    active])``
      - client_batches leaves: (n, T, ...) -- T local minibatches per client
      - A: (n, n) equal-neighbor matrix -- the sparse backends take the
        ELL pair ``(idx, w)`` of (n, d_max) tensors instead (int32 and
        fp32); tau: (n,) 0/1 sampling indicators; m: the eq.-4 divisor;
        eta: the step size (all fp32 tensors on the params' device)
      - active: optional (n,) 0/1 straggler mask; ``m`` must then be the
        effective sampled-and-active count
    Returns ``(new_global_params, mixed_deltas)`` -- ``None`` in place of
    the mixed deltas under the 'aggregate' and 'sparse_aggregate'
    backends.
    """
    check_backend(mixing_backend)
    if quant is not None:
        raise NotImplementedError(
            "quantized payloads are not yet ported to repro_torch "
            "(ROADMAP queue 1 item 8, quant slice)")

    def round_fn(global_params: PyTree, client_batches: PyTree,
                 A: torch.Tensor, tau: torch.Tensor, m: torch.Tensor,
                 eta: torch.Tensor,
                 active: Optional[torch.Tensor] = None
                 ) -> Tuple[PyTree, PyTree]:
        deltas = client_deltas(loss_fn, global_params, client_batches, eta)
        return _mix_and_update(global_params, deltas, A, tau, m,
                               mixing_backend=mixing_backend, active=active)

    return round_fn


def make_scanned_rounds(loss_fn: LossFn, K: int,
                        mixing_backend: str = "einsum", *, quant=None):
    """Build a driver that runs ``K`` global rounds over stacked columns:

    ``scanned(global_params, client_batches_seq, A_seq, tau_seq, m_seq,
    eta_seq[, active_seq]) -> (final_params, params_seq)``

      - client_batches_seq leaves: (K, n, T, ...) -- stacked round batches
      - A_seq (K, n, n), tau_seq (K, n), m_seq (K,), eta_seq (K,); the
        sparse backends take ``A_seq = (idx_seq, w_seq)`` of (K, n, d_max)
        tensors (``SparseAseq.ell()``, one d_max shared by all rounds)
      - active_seq: optional (K, n) stacked straggler masks
      - params_seq leaves: (K, ...) -- the global params after each round
        (params_seq[K-1] == final_params)

    The loop body is ``make_round_fn``'s round function on row ``t`` of
    each column, so the trajectory is bitwise-identical to K sequential
    ``round_fn`` calls on the same inputs.
    """
    round_fn = make_round_fn(loss_fn, mixing_backend, quant=quant)
    sparse = mixing_backend in SPARSE_BACKENDS

    def scanned(global_params: PyTree, client_batches_seq: PyTree,
                A_seq: torch.Tensor, tau_seq: torch.Tensor,
                m_seq: torch.Tensor, eta_seq: torch.Tensor,
                active_seq: Optional[torch.Tensor] = None
                ) -> Tuple[PyTree, PyTree]:
        params, seq = global_params, []
        for t in range(K):
            batches = tree_map(lambda b: b[t], client_batches_seq)
            active = active_seq[t] if active_seq is not None else None
            A = (tuple(a[t] for a in A_seq) if sparse else A_seq[t])
            params, _ = round_fn(params, batches, A, tau_seq[t],
                                 m_seq[t], eta_seq[t], active)
            seq.append(params)
        return params, tree_map(lambda *xs: torch.stack(xs), *seq)

    return scanned
