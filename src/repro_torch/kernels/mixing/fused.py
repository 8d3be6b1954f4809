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
    bytes (``csrc/row_groups.cuh``'s GEMV, instanced in
    ``csrc/mixing.cu``).  For a tall payload (the n = 100,000 scale
    round) it splits the rows into G groups, whose partial rows go to a
    (G, p) f32 scratch this wrapper allocates and a second pass sums in a
    fixed order; ``aggregate_row_groups`` gives G.  What the default
    'aggregate' round backend runs.
``mix_aggregate_cuda``
    one tiled product of the stacked ``[A; w]`` ((n+1) x n) with X: the
    mixed deltas in X's dtype and the f32 aggregate row from one read of
    X (``csrc/mixing.cu``: ``mix_staged_kernel`` on the 'staged' route,
    ``mix_aggregate_kernel`` on the 'generic' one; the rule is in the
    source's header).  The 'fused' backend with ``record_mixed=True``.
``aggregate_dequant_cuda`` / ``mix_aggregate_dequant_cuda``
    the same two products over a quantized payload in its wire format
    (stored int8 / int4 / fp8 containers ``Xq`` and fp32 per-block scales
    ``S``, ``repro_torch.fl.packing.QuantSpec``), dequantized inside the
    kernels (``csrc/quant_mixing.cu``): the port of
    ``aggregate_dequant_pallas`` and ``mix_aggregate_dequant_pallas``.
    Both outputs are f32.  The 'aggregate' and 'fused' round backends
    with a ``quant`` spec.  ``aggregate_dequant_cuda`` is
    ``aggregate_cuda``'s GEMV on the container, with its row groups
    (``aggregate_dequant_row_groups``).  ``mix_aggregate_dequant_cuda`` has
    ``mix_aggregate_cuda``'s two routes: 'staged' (n <= 128: the
    container slabs staged by TMA, each value decoded once a tile into
    an fp32 slab that ``mix_staged_kernel``'s loop reads) and 'generic'
    (``mix_aggregate_dequant_kernel``).

Each wrapper sends CPU tensors to its plain version (``ref.py``) and, for
a CUDA payload, launches its kernel on the current stream or raises; its
``launches`` attribute counts the launches, and the ``routes`` of
``mix_aggregate_cuda`` and ``mix_aggregate_dequant_cuda`` count their
launches by the route the library reports.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from . import _lib
from .ref import (aggregate_dequant_ref, aggregate_ref,
                  mix_aggregate_dequant_ref, mix_aggregate_ref)

__all__ = ["aggregate_cuda", "mix_aggregate_cuda", "aggregate_dequant_cuda",
           "mix_aggregate_dequant_cuda", "aggregate_row_groups",
           "aggregate_dequant_row_groups"]


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
    partial = _scratch(lib.repro_aggregate_row_groups(n, p, code), p,
                       X.device)
    device, stream = _lib.launch_args(X)
    rc = lib.repro_aggregate(w.data_ptr(), X.data_ptr(), agg.data_ptr(),
                             _ptr(partial), n, p, code, device, stream)
    _build.check(lib, rc, "aggregate")
    aggregate_cuda.launches += 1
    return agg


aggregate_cuda.launches = 0


def _scratch(groups: int, p: int, device: torch.device):
    """The GEMVs' (G, p) f32 scratch of partial rows, when G > 1."""
    if groups > 1:
        return torch.empty(groups, p, dtype=torch.float32, device=device)
    return None


def _ptr(t):
    return None if t is None else t.data_ptr()


def aggregate_row_groups(X: torch.Tensor) -> int:
    """The row groups G ``aggregate_cuda`` splits the rows of payload X
    into (``csrc/row_groups.cuh``): a function of X's shape and dtype
    alone.  Needs the built library (a CUDA machine)."""
    n, p = X.shape
    return _lib.lib().repro_aggregate_row_groups(n, p, _lib.dtype_code(X))


def aggregate_dequant_row_groups(Xq: torch.Tensor, S: torch.Tensor, *,
                                 storage: str, block: int) -> int:
    """The row groups G ``aggregate_dequant_cuda`` splits the rows of a
    quantized payload into; as ``aggregate_row_groups``."""
    code, n, p = _lib.check_quant_operands(Xq, S, storage, block)
    return _lib.quant_lib().repro_aggregate_dequant_row_groups(n, p, code)


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
    _lib.launch_routed(lib, lib.repro_mix_aggregate,
                       (B.data_ptr(), X.data_ptr(), mixed.data_ptr(),
                        agg.data_ptr(), n, n + 1, p, code, device, stream),
                       mix_aggregate_cuda)
    return mixed, agg


mix_aggregate_cuda.launches = 0
mix_aggregate_cuda.routes = dict.fromkeys(_lib.ROUTES, 0)


def aggregate_dequant_cuda(w: torch.Tensor, Xq: torch.Tensor,
                           S: torch.Tensor, *, storage: str, block: int
                           ) -> torch.Tensor:
    """``w @ deq(Xq, S)``: w (n,) f32, Xq (n, p * bits / 8) containers,
    S (n, p / block) f32 scales -> the (p,) f32 aggregate row, the
    dequantized payload never materialized."""
    code, n, p = _lib.check_quant_operands(Xq, S, storage, block)
    if not Xq.is_cuda:
        return aggregate_dequant_ref(w, Xq, S, storage, block)
    _lib.check_cuda_quant_operands(Xq, S)
    _lib.check_cuda_operand(w, "w", Xq.device, torch.float32, ndim=1)
    if w.shape[0] != n:
        raise ValueError(f"w must be ({n},), got {tuple(w.shape)}")
    agg = torch.empty(p, dtype=torch.float32, device=Xq.device)
    if p == 0:
        return agg
    lib = _lib.quant_lib()
    partial = _scratch(lib.repro_aggregate_dequant_row_groups(n, p, code), p,
                       Xq.device)
    device, stream = _lib.launch_args(Xq)
    rc = lib.repro_aggregate_dequant(w.data_ptr(), Xq.data_ptr(),
                                     S.data_ptr(), agg.data_ptr(),
                                     _ptr(partial), n, p, block, code,
                                     device, stream)
    _build.check(lib, rc, "aggregate_dequant")
    aggregate_dequant_cuda.launches += 1
    return agg


aggregate_dequant_cuda.launches = 0


def mix_aggregate_dequant_cuda(A: torch.Tensor, w: torch.Tensor,
                               Xq: torch.Tensor, S: torch.Tensor, *,
                               storage: str, block: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(A @ x, w @ x)`` over ``x = deq(Xq, S)`` from one read of the
    payload: A (n, n) f32, w (n,) f32, Xq / S as in
    ``aggregate_dequant_cuda`` -> mixed (n, p) f32 and the (p,) f32
    aggregate row."""
    code, n, p = _lib.check_quant_operands(Xq, S, storage, block)
    if not Xq.is_cuda:
        return mix_aggregate_dequant_ref(A, w, Xq, S, storage, block)
    _lib.check_cuda_quant_operands(Xq, S)
    _lib.check_cuda_operand(A, "A", Xq.device, torch.float32, ndim=2)
    _lib.check_cuda_operand(w, "w", Xq.device, torch.float32, ndim=1)
    if A.shape != (n, n) or w.shape[0] != n:
        raise ValueError(f"A must be ({n}, {n}) and w ({n},), got "
                         f"{tuple(A.shape)} and {tuple(w.shape)}")
    mixed = torch.empty(n, p, dtype=torch.float32, device=Xq.device)
    agg = torch.empty(p, dtype=torch.float32, device=Xq.device)
    if p == 0 or n == 0:
        return mixed, agg.zero_()
    B = torch.cat([A, w[None]])          # (n + 1, n): row n is w
    lib = _lib.quant_lib()
    device, stream = _lib.launch_args(Xq)
    _lib.launch_routed(lib, lib.repro_mix_aggregate_dequant,
                       (B.data_ptr(), Xq.data_ptr(), S.data_ptr(),
                        mixed.data_ptr(), agg.data_ptr(), n, p, block, code,
                        device, stream),
                       mix_aggregate_dequant_cuda)
    return mixed, agg


mix_aggregate_dequant_cuda.launches = 0
mix_aggregate_dequant_cuda.routes = dict.fromkeys(_lib.ROUTES, 0)
