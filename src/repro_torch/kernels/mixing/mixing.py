"""The D2D graph-mixing operator ``Delta = A @ X`` as a hand-written CUDA
kernel: the port of ``repro/kernels/mixing/mixing.py::mix_pallas``.

It serves the leaf-wise 'pallas' backend (``ops.mix``/``ops.mix_pytree``,
one launch per leaf) when mixed deltas are recorded.  The kernel is
``repro_mix_aggregate`` of ``csrc/mixing.cu`` without its combine row: a
shared-memory tiled fp32 product of the (n, n) ``A`` with X (n, p), output
in X's dtype.  It is bound about evenly by bytes (X read once, the mixed
deltas written once) and by fp32 CUDA-core operations (2 n^2 p).  It has
two routes (``_lib.ROUTES``; the static rule and the tiling are in the
source's header): 'staged' (n <= 128, whole 16-byte vectors a row,
16-byte aligned operands: persistent CTAs fed a TMA ring of X slabs) and
'generic' (anything else).
"""

from __future__ import annotations

import torch

from . import _lib
from .ref import mix_ref

__all__ = ["mix_cuda"]


def mix_cuda(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``A @ X``: A (n, n) f32, X (n, p) f32 or bf16, both contiguous ->
    (n, p) in X.dtype with fp32 accumulation.

    A CPU payload takes the plain version (``ref.mix_ref``); a CUDA
    payload launches the kernel on the current stream or raises.
    ``mix_cuda.launches`` counts the launches and ``mix_cuda.routes``
    counts them by the route the library reports it took."""
    if not X.is_cuda:
        return mix_ref(A, X)
    n, p = X.shape
    code = _lib.dtype_code(X)
    _lib.check_cuda_operand(X, "X", X.device, ndim=2)
    _lib.check_cuda_operand(A, "A", X.device, torch.float32, ndim=2)
    if A.shape != (n, n):
        raise ValueError(f"A must be ({n}, {n}), got {tuple(A.shape)}")
    mixed = torch.empty_like(X)
    if p == 0 or n == 0:
        return mixed
    lib = _lib.lib()
    device, stream = _lib.launch_args(X)
    _lib.launch_routed(lib, lib.repro_mix_aggregate,
                       (A.data_ptr(), X.data_ptr(), mixed.data_ptr(), None,
                        n, n, p, code, device, stream), mix_cuda)
    return mixed


mix_cuda.launches = 0
mix_cuda.routes = dict.fromkeys(_lib.ROUTES, 0)
