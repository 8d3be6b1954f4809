"""Sparse (ELL) D2D mixing (paper eq. 3, optionally with eq. 4) as a
hand-written CUDA kernel: the port of ``repro/kernels/mixing/sparse.py``'s
``sparse_mix_pallas`` and ``sparse_mix_aggregate_pallas``.

``A`` arrives in the ELLPACK form of ``repro_torch.core.sparse.SparseA.
ell()``: ``idx`` (n, d_max) int32 in-neighbour ids and ``w`` (n, d_max)
f32 weights, padding slots ``index 0, weight 0.0``.  Then

    mixed[i] = sum_k w[i, k] * X[idx[i, k]]      (eq. 3, O(n d_max p))
    agg      = wrow @ X                          (eq. 4 with the combine
                                                  row ``(tau^T A) / m``)

``sparse_mix_cuda``
    the gather alone (``ops.sparse_mix``).
``sparse_mix_aggregate_cuda``
    the gather and the combine-row product from one pass over X: the
    'sparse' backend with ``record_mixed=True``.
``sparse_mix_aggregate_dequant_cuda``
    the same over a quantized payload in its wire format (``Xq``
    containers, ``S`` fp32 per-block scales), each gathered neighbour
    value dequantized with that row's own scale inside the kernel
    (``csrc/quant_mixing.cu``; the port of
    ``sparse_mix_aggregate_dequant_pallas``): the 'sparse' backend with
    ``record_mixed=True`` and a ``quant`` spec.  Both outputs are f32.
    It has the two routes below, by n and d_max alone (a quantized
    payload is always aligned and whole): 'staged' decodes each value of
    a TMA-staged container slab once a tile into an fp32 slab that the
    gather reads, 'generic' (``sparse_mix_dequant_kernel``) decodes each
    gathered value.

Both launch ``repro_sparse_mix_aggregate`` of ``csrc/sparse_mixing.cu``
(the mix-only call passes no combine row); it is bound by X's bytes.  It
has two routes (``_lib.ROUTES``; the static rule is in the source's
header): 'staged' (n <= 128, d_max <= 64, whole 16-byte vectors a row,
16-byte aligned operands: persistent CTAs gather from a TMA ring of X
slabs in shared memory) and 'generic' (anything else, such as the
n = 100,000 ring: neighbour rows gathered from global memory).  The
aggregate-only 'sparse_aggregate' backend needs no kernel here: its
combine row feeds ``fused.aggregate_cuda`` (or
``fused.aggregate_dequant_cuda`` for a quantized payload).

Each wrapper sends CPU tensors to its plain version (``ref.py``) and, for
a CUDA payload, launches the kernel on the current stream or raises; its
``launches`` attribute counts the launches, and ``routes`` counts them by
the route the library reports.
``idx`` values must lie in ``[0, n)``: the kernel does not check them
(the plan's CSR, from which the engine builds the ELL, guarantees it;
out of range, the staged route reads outside its slab in shared memory,
the generic one outside X).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _lib
from .ref import (sparse_mix_aggregate_dequant_ref, sparse_mix_aggregate_ref,
                  sparse_mix_ref)

__all__ = ["sparse_mix_cuda", "sparse_mix_aggregate_cuda",
           "sparse_mix_aggregate_dequant_cuda"]


def _launch(idx: torch.Tensor, w: torch.Tensor, wrow: Optional[torch.Tensor],
            X: torch.Tensor, wrapper):
    """Check the operands and launch the kernel for ``wrapper`` (whose
    counts it raises); ``(mixed, agg or None)``.  The (G, p) scratch is
    sized by the generic route's rule; the staged route leaves it
    untouched."""
    n, p = X.shape
    code = _lib.dtype_code(X)
    _lib.check_cuda_operand(X, "X", X.device, ndim=2)
    _lib.check_cuda_operand(idx, "idx", X.device, torch.int32, ndim=2)
    _lib.check_cuda_operand(w, "w", X.device, torch.float32, ndim=2)
    d_max = idx.shape[1]
    if idx.shape[0] != n or w.shape != idx.shape:
        raise ValueError(f"idx and w must both be ({n}, d_max), got "
                         f"{tuple(idx.shape)} and {tuple(w.shape)}")
    mixed = torch.empty_like(X)
    agg = partial = None
    lib = _lib.sparse_lib()
    if wrow is not None:
        _lib.check_cuda_operand(wrow, "wrow", X.device, torch.float32,
                                ndim=1)
        if wrow.shape[0] != n:
            raise ValueError(f"wrow must be ({n},), got {tuple(wrow.shape)}")
        agg = torch.empty(p, dtype=torch.float32, device=X.device)
        groups = lib.repro_sparse_row_groups(n, p, code)
        if groups > 1:
            partial = torch.empty(groups, p, dtype=torch.float32,
                                  device=X.device)
    if n == 0 or p == 0:
        return mixed, (None if agg is None else agg.zero_())
    device, stream = _lib.launch_args(X)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _lib.launch_routed(lib, lib.repro_sparse_mix_aggregate,
                       (idx.data_ptr(), w.data_ptr(), ptr(wrow),
                        X.data_ptr(), mixed.data_ptr(), ptr(agg),
                        ptr(partial), n, d_max, p, code, device, stream),
                       wrapper)
    return mixed, agg


def sparse_mix_cuda(idx: torch.Tensor, w: torch.Tensor, X: torch.Tensor
                    ) -> torch.Tensor:
    """``mixed[i] = sum_k w[i, k] * X[idx[i, k]]``: idx (n, d_max) int32,
    w (n, d_max) f32, X (n, p) f32 or bf16, all contiguous -> (n, p) in
    X.dtype with fp32 accumulation."""
    if not X.is_cuda:
        return sparse_mix_ref(idx, w, X)
    return _launch(idx, w, None, X, sparse_mix_cuda)[0]


sparse_mix_cuda.launches = 0
sparse_mix_cuda.routes = dict.fromkeys(_lib.ROUTES, 0)


def sparse_mix_aggregate_cuda(idx: torch.Tensor, w: torch.Tensor,
                              wrow: torch.Tensor, X: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ELL gather and ``wrow @ X`` from one pass over X: idx/w as in
    ``sparse_mix_cuda``, wrow (n,) f32 -> mixed (n, p) in X.dtype and the
    (p,) f32 aggregate row."""
    if not X.is_cuda:
        return sparse_mix_aggregate_ref(idx, w, wrow, X)
    return _launch(idx, w, wrow, X, sparse_mix_aggregate_cuda)


sparse_mix_aggregate_cuda.launches = 0
sparse_mix_aggregate_cuda.routes = dict.fromkeys(_lib.ROUTES, 0)


def sparse_mix_aggregate_dequant_cuda(idx: torch.Tensor, w: torch.Tensor,
                                      wrow: torch.Tensor, Xq: torch.Tensor,
                                      S: torch.Tensor, *, storage: str,
                                      block: int
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ELL gather and ``wrow @ x`` over ``x = deq(Xq, S)`` from one
    pass over the payload: idx/w as in ``sparse_mix_cuda``, wrow (n,) f32,
    Xq (n, p * bits / 8) containers, S (n, p / block) f32 scales -> mixed
    (n, p) f32 (bitwise the plain version's) and the (p,) f32 row."""
    code, n, p = _lib.check_quant_operands(Xq, S, storage, block)
    if not Xq.is_cuda:
        return sparse_mix_aggregate_dequant_ref(idx, w, wrow, Xq, S,
                                                storage, block)
    _lib.check_cuda_quant_operands(Xq, S)
    _lib.check_cuda_operand(idx, "idx", Xq.device, torch.int32, ndim=2)
    _lib.check_cuda_operand(w, "w", Xq.device, torch.float32, ndim=2)
    _lib.check_cuda_operand(wrow, "wrow", Xq.device, torch.float32, ndim=1)
    if idx.shape[0] != n or w.shape != idx.shape or wrow.shape[0] != n:
        raise ValueError(f"idx and w must be ({n}, d_max) and wrow ({n},), "
                         f"got {tuple(idx.shape)}, {tuple(w.shape)} and "
                         f"{tuple(wrow.shape)}")
    mixed = torch.empty(n, p, dtype=torch.float32, device=Xq.device)
    agg = torch.empty(p, dtype=torch.float32, device=Xq.device)
    if n == 0 or p == 0:
        return mixed, agg.zero_()
    lib = _lib.quant_lib()
    groups = lib.repro_sparse_dequant_row_groups(n, p)
    partial = (torch.empty(groups, p, dtype=torch.float32, device=Xq.device)
               if groups > 1 else None)
    device, stream = _lib.launch_args(Xq)
    _lib.launch_routed(lib, lib.repro_sparse_mix_aggregate_dequant,
                       (idx.data_ptr(), w.data_ptr(), wrow.data_ptr(),
                        Xq.data_ptr(), S.data_ptr(), mixed.data_ptr(),
                        agg.data_ptr(),
                        None if partial is None else partial.data_ptr(), n,
                        idx.shape[1], p, block, code, device, stream),
                       sparse_mix_aggregate_dequant_cuda)
    return mixed, agg


sparse_mix_aggregate_dequant_cuda.launches = 0
sparse_mix_aggregate_dequant_cuda.routes = dict.fromkeys(_lib.ROUTES, 0)
