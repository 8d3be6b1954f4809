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

Both launch ``repro_sparse_mix_aggregate`` of ``csrc/sparse_mixing.cu``
(the mix-only call passes no combine row); it is bound by X's bytes (see
the source's header).  The aggregate-only 'sparse_aggregate' backend needs
no kernel here: its combine row feeds ``fused.aggregate_cuda``.

Each wrapper sends CPU tensors to its plain version (``ref.py``) and, for
a CUDA payload, launches the kernel on the current stream or raises; its
``launches`` attribute counts the launches.  ``idx`` values must lie in
``[0, n)``: the kernel does not check them (the plan's CSR, from which
the engine builds the ELL, guarantees it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from . import _lib
from .ref import sparse_mix_aggregate_ref, sparse_mix_ref

__all__ = ["sparse_mix_cuda", "sparse_mix_aggregate_cuda"]


def _launch(idx: torch.Tensor, w: torch.Tensor, wrow: Optional[torch.Tensor],
            X: torch.Tensor, wrapper):
    """Check the operands and launch the kernel for ``wrapper`` (whose
    count it raises); ``(mixed, agg or None)``."""
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

    rc = lib.repro_sparse_mix_aggregate(
        idx.data_ptr(), w.data_ptr(), ptr(wrow), X.data_ptr(),
        mixed.data_ptr(), ptr(agg), ptr(partial), n, d_max, p, code, device,
        stream)
    _build.check(lib, rc, wrapper.__name__)
    wrapper.launches += 1
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
