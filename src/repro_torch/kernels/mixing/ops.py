"""Public graph-mixing entry points: combine-row math, pytree plumbing and
dtype groups around the kernel wrappers (port of
``repro.kernels.mixing.ops``).

* ``mix`` / ``mix_pytree``       -- eq. 3 only (``Delta = A @ X``), one
                                    ``mixing.mix_cuda`` launch per leaf.
* ``mix_aggregate``              -- fused one-pass eq. 3 + eq. 4: mixed
                                    deltas plus the tau-weighted D2S
                                    aggregate row from one read of the
                                    payload (``fused.mix_aggregate_cuda``).
* ``aggregate``                  -- aggregate-only fast path exploiting
                                    ``sum_i tau_i (A X)_i = (tau^T A) X``
                                    (``fused.aggregate_cuda``).
* ``mix_aggregate_grouped`` /    -- the same one-pass schedules over a
  ``aggregate_grouped``             dtype-grouped packed tree
                                    (``repro_torch.fl.packing``): one
                                    launch per dtype group sharing one
                                    precombined weight row.
* ``sparse_mix`` /               -- the same on the ELL form of ``A``
  ``sparse_mix_aggregate`` /        (``idx``, ``w`` of shape (n, d_max),
  ``sparse_aggregate`` (+           ``core.sparse.SparseA.ell()``): the
  ``_grouped``)                     gather kernels of ``sparse.py`` and,
                                    for the aggregate-only path, the
                                    combine row ``combine_weights_ell``
                                    into ``fused.aggregate_cuda``.
                                    Nothing (n, n) exists.
* ``*_q``                        -- the one-pass schedules over a
                                    quantized payload in its wire format
                                    (``repro_torch.fl.packing.QuantSpec``:
                                    stored containers + fp32 per-block
                                    scales), dequantized inside the
                                    kernels (``fused.*_dequant_cuda``,
                                    ``sparse.sparse_mix_aggregate_dequant_
                                    cuda``); mixed and aggregate outputs
                                    are fp32.

The reference's TPU knobs are gone: there is no ``interpret`` mode, and no
``chunk``/8-sublane padding (``_pad_inputs``, ``_pad_sparse_inputs``) --
the CUDA kernels mask ragged n and p themselves, and the quantized
entry points have no ``chunk`` and no ``_pad_quant_inputs``.  CPU tensors
run the plain versions (``ref.py``), CUDA tensors the kernels.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core.pytree import tree_map
from .fused import (aggregate_cuda, aggregate_dequant_cuda, mix_aggregate_cuda,
                    mix_aggregate_dequant_cuda)
from .mixing import mix_cuda
from .sparse import (sparse_mix_aggregate_cuda,
                     sparse_mix_aggregate_dequant_cuda, sparse_mix_cuda)

PyTree = Any

__all__ = ["mix", "mix_pytree", "mix_aggregate", "aggregate",
           "mix_aggregate_grouped", "aggregate_grouped", "combine_weights",
           "combine_weights_ell", "sparse_mix", "sparse_mix_aggregate",
           "sparse_aggregate", "sparse_mix_aggregate_grouped",
           "sparse_aggregate_grouped", "mix_aggregate_q", "aggregate_q",
           "mix_aggregate_grouped_q", "aggregate_grouped_q",
           "sparse_mix_aggregate_q", "sparse_aggregate_q",
           "sparse_mix_aggregate_grouped_q", "sparse_aggregate_grouped_q"]


def combine_weights(A: torch.Tensor, tau: torch.Tensor, m,
                    active: Optional[torch.Tensor] = None,
                    weights=None) -> torch.Tensor:
    """Precombined D2S weight row ``w = (tau^T A) / m`` (fp32, shape (n,)).

    The identity ``(1/m) sum_i tau_i (A X)_i = w @ X`` is what every
    one-pass aggregate path exploits; this is its single definition.

    ``active`` is the optional (n,) 0/1 straggler mask: a dropped client
    neither uploads (its entry of ``tau`` is zeroed) nor contributes a
    delta to its neighbors (its *column* of the combine row is zeroed).
    ``m`` must already be the effective sampled-and-active count.  An
    all-ones mask is bitwise-identical to ``active=None``.

    ``weights`` is an optional per-upload discount (scalar or (n,) fp32)
    on the upload leg only; ``weights = 1.0`` is bitwise-identical to
    ``weights=None`` (IEEE ``x * 1.0 == x``).

    ``m == 0`` yields the all-zero row instead of inf/nan; for ``m != 0``
    the guard is bitwise-inert.
    """
    tau = _fold_mask(tau, active, weights)
    w = tau @ A.float()
    w = _safe_divide_by_m(w, m)
    if active is not None:
        w = w * active.float()
    return w


def combine_weights_ell(idx: torch.Tensor, w_ell: torch.Tensor,
                        tau: torch.Tensor, m,
                        active: Optional[torch.Tensor] = None,
                        weights=None) -> torch.Tensor:
    """``combine_weights`` from the ELL form of ``A``, never densifying:
    ``w[j] = (1/m) sum_{(i,k): idx[i,k]=j} tau_i w_ell[i,k]``, a segment
    sum over the stored entries.  Masking semantics and the ``m == 0``
    guard are those of the dense definition (allclose to it, not
    bitwise: the reduction order differs).

    The segment sum is deterministic on every device (``_segment_sum``):
    no float atomics, so a replay and the scanned driver reproduce a run
    bitwise on the card too."""
    tau = _fold_mask(tau, active, weights)
    contrib = tau[:, None] * w_ell.float()
    w = _segment_sum(contrib.reshape(-1), idx.reshape(-1), tau.shape[0])
    w = _safe_divide_by_m(w, m)
    if active is not None:
        w = w * active.float()
    return w


def _segment_sum(values: torch.Tensor, segments: torch.Tensor,
                 n: int) -> torch.Tensor:
    """``out[j] = sum of values[e] over segments[e] == j`` in a fixed
    order: the entries are stable-sorted by segment (so each segment keeps
    the reference's flat entry order), laid out one segment per row of an
    (n, width) zero matrix at distinct positions, and summed along the
    rows.  ``index_add_`` would use float atomics on CUDA, whose order
    changes from run to run.

    Zero-weight entries (the ELL padding slots, index 0 weight 0.0) are
    left out first: they add an exact 0 and would otherwise widen segment
    0 to the padding count.  Two host syncs (the mask and the width)."""
    keep = values != 0
    values, segments = values[keep], segments[keep].long()
    out = torch.zeros(n, dtype=torch.float32, device=values.device)
    if values.numel() == 0:
        return out
    order = torch.argsort(segments, stable=True)
    segments, values = segments[order], values[order]
    counts = torch.bincount(segments, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(segments.numel(), device=values.device) \
        - starts[segments]
    table = torch.zeros(n, int(counts.max()), dtype=torch.float32,
                        device=values.device)
    table[segments, pos] = values
    return table.sum(1)


def _fold_mask(tau, active, weights):
    """The shared upload-leg folding: tau * active * weights, fp32."""
    tau = tau.float()
    if active is not None:
        tau = tau * active.float()
    if weights is not None:
        tau = tau * torch.as_tensor(weights, dtype=torch.float32,
                                    device=tau.device)
    return tau


def _safe_divide_by_m(w, m):
    """``w / m`` with ``m == 0 -> 0``; bitwise ``w / m`` when ``m != 0``."""
    m = torch.as_tensor(m, dtype=torch.float32, device=w.device)
    zero = m == 0
    return torch.where(zero, torch.zeros_like(w),
                       w / torch.where(zero, torch.ones_like(m), m))


def mix(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Delta = A @ X for arbitrary (n, p), in X.dtype."""
    return mix_cuda(A.float().contiguous(), X.contiguous())


def mix_pytree(A: torch.Tensor, deltas: PyTree) -> PyTree:
    """Apply the mixing kernel to a pytree of per-client deltas (leaves
    with leading client axis n), flattening trailing dims per leaf: one
    launch *per leaf* (the packed one-pass paths launch once per dtype
    group)."""
    A = A.float().contiguous()
    return tree_map(
        lambda d: mix_cuda(A, d.reshape(d.shape[0], -1).contiguous())
        .reshape(d.shape), deltas)


def mix_aggregate(A: torch.Tensor, tau: torch.Tensor, m, X: torch.Tensor,
                  *, active: Optional[torch.Tensor] = None, weights=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused eq. 3 + eq. 4 over an (n, p) payload: ``(mixed, agg)`` with
    mixed (n, p) in X.dtype and the f32 row ``(1/m) sum_i tau_i (A @ X)_i``.

    ``active``/``weights`` fold into the aggregate row (``combine_weights``);
    the *mixed* output reflects dropped clients only if the caller already
    zeroed their rows of ``X``."""
    w = combine_weights(A, tau, m, active, weights)
    return mix_aggregate_cuda(A.float().contiguous(), w.contiguous(),
                              X.contiguous())


def aggregate(A: torch.Tensor, tau: torch.Tensor, m, X: torch.Tensor, *,
              active: Optional[torch.Tensor] = None,
              weights=None) -> torch.Tensor:
    """Aggregate-only fast path: the f32 row ``((tau^T A) / m) @ X`` (p,),
    reading ``X`` once and never materializing the mixed deltas."""
    w = combine_weights(A, tau, m, active, weights)
    return aggregate_cuda(w.contiguous(), X.contiguous())


def mix_aggregate_grouped(A: torch.Tensor, tau: torch.Tensor, m,
                          bufs: Tuple[torch.Tensor, ...], *,
                          active: Optional[torch.Tensor] = None,
                          weights=None
                          ) -> Tuple[Tuple[torch.Tensor, ...],
                                     Tuple[torch.Tensor, ...]]:
    """``mix_aggregate`` over the per-dtype group buffers of
    ``repro_torch.fl.packing.pack``: one launch per group.  Returns
    ``(mixed_bufs, agg_rows)``."""
    A32 = A.float().contiguous()
    w = combine_weights(A, tau, m, active, weights).contiguous()
    out = [mix_aggregate_cuda(A32, w, b.contiguous()) for b in bufs]
    return tuple(mb for mb, _ in out), tuple(r for _, r in out)


def aggregate_grouped(A: torch.Tensor, tau: torch.Tensor, m,
                      bufs: Tuple[torch.Tensor, ...], *,
                      active: Optional[torch.Tensor] = None,
                      weights=None) -> Tuple[torch.Tensor, ...]:
    """Aggregate-only ``mix_aggregate_grouped``: per-group f32 rows, the
    mixed deltas never materialized."""
    w = combine_weights(A, tau, m, active, weights).contiguous()
    return tuple(aggregate_cuda(w, b.contiguous()) for b in bufs)


# --------------------------------------------------------------------------
# Sparse (ELL) entry points -- A as padded neighbour lists
# (``repro_torch.core.sparse.SparseA.ell()``), never an (n, n) array.
# --------------------------------------------------------------------------


def sparse_mix(idx: torch.Tensor, w: torch.Tensor, X: torch.Tensor
               ) -> torch.Tensor:
    """Sparse ``Delta = A @ X`` for arbitrary (n, p): the ELL gather
    kernel, O(n d_max p) work.  allclose to the dense ``mix`` (fp32
    accumulation both sides; the order differs)."""
    return sparse_mix_cuda(idx.contiguous(), w.float().contiguous(),
                           X.contiguous())


def sparse_mix_aggregate(idx: torch.Tensor, w: torch.Tensor,
                         tau: torch.Tensor, m, X: torch.Tensor, *,
                         active: Optional[torch.Tensor] = None, weights=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse fused eq. 3 + eq. 4: one pass over ``X`` emits the mixed
    payload and the fp32 aggregate row, the combine row built by
    ``combine_weights_ell`` (O(nnz)).  Mask/weight semantics match
    ``mix_aggregate``."""
    wrow = combine_weights_ell(idx, w, tau, m, active, weights)
    return sparse_mix_aggregate_cuda(idx.contiguous(),
                                     w.float().contiguous(),
                                     wrow.contiguous(), X.contiguous())


def sparse_aggregate(idx: torch.Tensor, w: torch.Tensor, tau: torch.Tensor,
                     m, X: torch.Tensor, *,
                     active: Optional[torch.Tensor] = None,
                     weights=None) -> torch.Tensor:
    """Sparse aggregate-only fast path: the combine row is a segment sum
    over the ELL entries, then ``w @ X`` is the dense aggregate kernel
    (``fused.aggregate_cuda``) -- no new kernel, nothing (n, n)."""
    wrow = combine_weights_ell(idx, w, tau, m, active, weights)
    return aggregate_cuda(wrow.contiguous(), X.contiguous())


def sparse_mix_aggregate_grouped(idx: torch.Tensor, w: torch.Tensor,
                                 tau: torch.Tensor, m,
                                 bufs: Tuple[torch.Tensor, ...], *,
                                 active: Optional[torch.Tensor] = None,
                                 weights=None
                                 ) -> Tuple[Tuple[torch.Tensor, ...],
                                            Tuple[torch.Tensor, ...]]:
    """``mix_aggregate_grouped`` on the ELL form: one sparse fused launch
    per dtype group, sharing one combine row."""
    idx = idx.contiguous()
    w32 = w.float().contiguous()
    wrow = combine_weights_ell(idx, w, tau, m, active, weights).contiguous()
    out = [sparse_mix_aggregate_cuda(idx, w32, wrow, b.contiguous())
           for b in bufs]
    return tuple(mb for mb, _ in out), tuple(r for _, r in out)


def sparse_aggregate_grouped(idx: torch.Tensor, w: torch.Tensor,
                             tau: torch.Tensor, m,
                             bufs: Tuple[torch.Tensor, ...], *,
                             active: Optional[torch.Tensor] = None,
                             weights=None) -> Tuple[torch.Tensor, ...]:
    """``aggregate_grouped`` on the ELL form: per-group fp32 rows, the
    mixed deltas never materialized, nothing (n, n)."""
    wrow = combine_weights_ell(idx, w, tau, m, active, weights).contiguous()
    return tuple(aggregate_cuda(wrow, b.contiguous()) for b in bufs)


# --------------------------------------------------------------------------
# Quantized-payload entry points (``_q`` suffix): the same one-pass
# schedules over a wire-format payload -- stored containers ``Xq`` + fp32
# per-block scales ``S`` in, fp32 mixed / aggregate out.  ``quant`` is the
# ``repro_torch.fl.packing.QuantSpec``.  A straggler mask zeroes dropped
# clients out of the *aggregate* leg only (combine row); callers that also
# need a masked mixed output zero the dropped rows of ``S`` first.
# --------------------------------------------------------------------------


def _q(quant):
    return dict(storage=quant.storage, block=quant.block)


def mix_aggregate_q(A: torch.Tensor, tau: torch.Tensor, m, Xq: torch.Tensor,
                    S: torch.Tensor, *, quant,
                    active: Optional[torch.Tensor] = None, weights=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused eq. 3 + eq. 4 over one quantized group buffer: the f32
    (n, P) mixed deltas and the f32 (P,) aggregate row."""
    w = combine_weights(A, tau, m, active, weights)
    return mix_aggregate_dequant_cuda(A.float().contiguous(), w.contiguous(),
                                      Xq.contiguous(), S.contiguous(),
                                      **_q(quant))


def aggregate_q(A: torch.Tensor, tau: torch.Tensor, m, Xq: torch.Tensor,
                S: torch.Tensor, *, quant,
                active: Optional[torch.Tensor] = None,
                weights=None) -> torch.Tensor:
    """Aggregate-only fast path over one quantized group buffer: the f32
    row ``((tau^T A)/m) @ deq(Xq, S)`` (P,), streaming the compressed
    payload once."""
    w = combine_weights(A, tau, m, active, weights)
    return aggregate_dequant_cuda(w.contiguous(), Xq.contiguous(),
                                  S.contiguous(), **_q(quant))


def mix_aggregate_grouped_q(A: torch.Tensor, tau: torch.Tensor, m,
                            stored: Tuple[torch.Tensor, ...],
                            scales: Tuple[torch.Tensor, ...], *, quant,
                            active: Optional[torch.Tensor] = None,
                            weights=None
                            ) -> Tuple[Tuple[torch.Tensor, ...],
                                       Tuple[torch.Tensor, ...]]:
    """``mix_aggregate_grouped`` over the wire format
    (``packing.quantize_packed`` output): one fused dequant launch per
    group, sharing one combine row.  Returns f32 ``(mixed_bufs,
    agg_rows)``."""
    A32 = A.float().contiguous()
    w = combine_weights(A, tau, m, active, weights).contiguous()
    out = [mix_aggregate_dequant_cuda(A32, w, xq.contiguous(),
                                      s.contiguous(), **_q(quant))
           for xq, s in zip(stored, scales)]
    return tuple(mb for mb, _ in out), tuple(r for _, r in out)


def aggregate_grouped_q(A: torch.Tensor, tau: torch.Tensor, m,
                        stored: Tuple[torch.Tensor, ...],
                        scales: Tuple[torch.Tensor, ...], *, quant,
                        active: Optional[torch.Tensor] = None,
                        weights=None) -> Tuple[torch.Tensor, ...]:
    """``aggregate_grouped`` over the wire format: per-group f32 rows, one
    aggregate-dequant launch per group."""
    w = combine_weights(A, tau, m, active, weights).contiguous()
    return tuple(aggregate_dequant_cuda(w, xq.contiguous(), s.contiguous(),
                                        **_q(quant))
                 for xq, s in zip(stored, scales))


def sparse_mix_aggregate_q(idx: torch.Tensor, w: torch.Tensor,
                           tau: torch.Tensor, m, Xq: torch.Tensor,
                           S: torch.Tensor, *, quant,
                           active: Optional[torch.Tensor] = None,
                           weights=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse fused eq. 3 + eq. 4 over one quantized group buffer: the
    ELL gather and the combine-row product over values dequantized in
    the kernel.  Mask/weight semantics match ``mix_aggregate_q``."""
    wrow = combine_weights_ell(idx, w, tau, m, active, weights)
    return sparse_mix_aggregate_dequant_cuda(
        idx.contiguous(), w.float().contiguous(), wrow.contiguous(),
        Xq.contiguous(), S.contiguous(), **_q(quant))


def sparse_aggregate_q(idx: torch.Tensor, w: torch.Tensor,
                       tau: torch.Tensor, m, Xq: torch.Tensor,
                       S: torch.Tensor, *, quant,
                       active: Optional[torch.Tensor] = None,
                       weights=None) -> torch.Tensor:
    """Sparse aggregate-only dequant path: the combine row is the O(nnz)
    segment sum, then the aggregate-dequant kernel streams the compressed
    payload -- no sparse kernel needed."""
    wrow = combine_weights_ell(idx, w, tau, m, active, weights)
    return aggregate_dequant_cuda(wrow.contiguous(), Xq.contiguous(),
                                  S.contiguous(), **_q(quant))


def sparse_mix_aggregate_grouped_q(idx: torch.Tensor, w: torch.Tensor,
                                   tau: torch.Tensor, m,
                                   stored: Tuple[torch.Tensor, ...],
                                   scales: Tuple[torch.Tensor, ...], *,
                                   quant,
                                   active: Optional[torch.Tensor] = None,
                                   weights=None
                                   ) -> Tuple[Tuple[torch.Tensor, ...],
                                              Tuple[torch.Tensor, ...]]:
    """``sparse_mix_aggregate_grouped`` over the wire format."""
    idx = idx.contiguous()
    w32 = w.float().contiguous()
    wrow = combine_weights_ell(idx, w, tau, m, active, weights).contiguous()
    out = [sparse_mix_aggregate_dequant_cuda(idx, w32, wrow, xq.contiguous(),
                                             s.contiguous(), **_q(quant))
           for xq, s in zip(stored, scales)]
    return tuple(mb for mb, _ in out), tuple(r for _, r in out)


def sparse_aggregate_grouped_q(idx: torch.Tensor, w: torch.Tensor,
                               tau: torch.Tensor, m,
                               stored: Tuple[torch.Tensor, ...],
                               scales: Tuple[torch.Tensor, ...], *, quant,
                               active: Optional[torch.Tensor] = None,
                               weights=None) -> Tuple[torch.Tensor, ...]:
    """``sparse_aggregate_grouped`` over the wire format."""
    wrow = combine_weights_ell(idx, w, tau, m, active, weights).contiguous()
    return tuple(aggregate_dequant_cuda(wrow, xq.contiguous(), s.contiguous(),
                                        **_q(quant))
                 for xq, s in zip(stored, scales))
