"""Fused one-pass D2D mix + D2S aggregate (paper eq. 3 + 4) as
hand-written CUDA kernels: the port of
``repro/kernels/mixing/fused.py``'s ``mix_aggregate_pallas`` and
``aggregate_pallas``.

Both equations are linear in the payload ``X`` (n clients x p model
dims), so with the precombined row ``w = (tau^T A) / m``

    mixed = A @ X            (eq. 3)
    agg   = w @ X            (eq. 4: (1/m) sum_i tau_i mixed_i)

``aggregate_cuda``
    writes only the f32 row: a GEMV that streams X once, bound by X's
    bytes (``csrc/mixing.cu::aggregate_kernel``).  What the default
    'aggregate' round backend runs.
``mix_aggregate_cuda``
    one tiled product of the stacked ``[A; w]`` ((n+1) x n) with X: the
    mixed deltas in X's dtype and the f32 aggregate row from one read of
    X (``csrc/mixing.cu::mix_aggregate_kernel``).  The 'fused' backend
    with ``record_mixed=True``.

Each wrapper sends CPU tensors to its plain version (``ref.py``) and, for
a CUDA payload, launches its kernel on the current stream or raises; its
``launches`` attribute counts the launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from . import _lib
from .ref import aggregate_ref, mix_aggregate_ref

__all__ = ["aggregate_cuda", "mix_aggregate_cuda"]


def aggregate_cuda(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``w @ X``: w (n,) f32, X (n, p) f32 or bf16, both contiguous ->
    the (p,) f32 aggregate row."""
    if not X.is_cuda:
        return aggregate_ref(w, X)
    n, p = X.shape
    code = _lib.dtype_code(X)
    _lib.check_cuda_operand(X, "X", X.device, ndim=2)
    _lib.check_cuda_operand(w, "w", X.device, torch.float32, ndim=1)
    if w.shape[0] != n:
        raise ValueError(f"w must be ({n},), got {tuple(w.shape)}")
    agg = torch.empty(p, dtype=torch.float32, device=X.device)
    if p == 0:
        return agg
    lib = _lib.lib()
    device, stream = _lib.launch_args(X)
    rc = lib.repro_aggregate(w.data_ptr(), X.data_ptr(), agg.data_ptr(), n,
                             p, code, device, stream)
    _build.check(lib, rc, "aggregate")
    aggregate_cuda.launches += 1
    return agg


aggregate_cuda.launches = 0


def mix_aggregate_cuda(A: torch.Tensor, w: torch.Tensor, X: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(A @ X, w @ X)`` from one read of X: A (n, n) f32, w (n,) f32,
    X (n, p) f32 or bf16 -> mixed (n, p) in X.dtype and the (p,) f32
    aggregate row."""
    if not X.is_cuda:
        return mix_aggregate_ref(A, w, X)
    n, p = X.shape
    code = _lib.dtype_code(X)
    _lib.check_cuda_operand(X, "X", X.device, ndim=2)
    _lib.check_cuda_operand(A, "A", X.device, torch.float32, ndim=2)
    _lib.check_cuda_operand(w, "w", X.device, torch.float32, ndim=1)
    if A.shape != (n, n) or w.shape[0] != n:
        raise ValueError(f"A must be ({n}, {n}) and w ({n},), got "
                         f"{tuple(A.shape)} and {tuple(w.shape)}")
    mixed = torch.empty_like(X)
    agg = torch.empty(p, dtype=torch.float32, device=X.device)
    if p == 0 or n == 0:
        return mixed, agg.zero_()
    B = torch.cat([A, w[None]])          # (n + 1, n): row n is w
    lib = _lib.lib()
    device, stream = _lib.launch_args(X)
    rc = lib.repro_mix_aggregate(B.data_ptr(), X.data_ptr(),
                                 mixed.data_ptr(), agg.data_ptr(), n, n + 1,
                                 p, code, device, stream)
    _build.check(lib, rc, "mix_aggregate")
    mix_aggregate_cuda.launches += 1
    return mixed, agg


mix_aggregate_cuda.launches = 0
