"""Public graph-mixing entry points: combine-row math, pytree plumbing and
dtype groups around the kernel wrappers (dense subset of
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

The reference's TPU knobs are gone: there is no ``interpret`` mode, and no
``chunk``/8-sublane padding -- the CUDA kernels mask ragged n and p
themselves.  CPU tensors run the plain versions (``ref.py``), CUDA
tensors the kernels.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core.pytree import tree_map
from .fused import aggregate_cuda, mix_aggregate_cuda
from .mixing import mix_cuda

PyTree = Any

__all__ = ["mix", "mix_pytree", "mix_aggregate", "aggregate",
           "mix_aggregate_grouped", "aggregate_grouped", "combine_weights"]


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
