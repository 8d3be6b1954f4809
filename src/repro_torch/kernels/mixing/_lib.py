"""ctypes bindings of ``csrc/mixing.cu`` and ``csrc/sparse_mixing.cu``
(C ABIs documented there)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["lib", "sparse_lib", "dtype_code", "launch_args",
           "check_cuda_operand"]

_LIB = None
_SPARSE_LIB = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def lib() -> ctypes.CDLL:
    """The built library with its argument types bound (builds on first
    use)."""
    global _LIB
    if _LIB is None:
        handle = _build.load("mixing")
        handle.repro_aggregate.argtypes = [_P, _P, _P, _I, _LL, _I, _I, _P]
        handle.repro_aggregate.restype = _I
        handle.repro_mix_aggregate.argtypes = [_P, _P, _P, _P, _I, _I, _LL,
                                               _I, _I, _P]
        handle.repro_mix_aggregate.restype = _I
        _LIB = handle
    return _LIB


def sparse_lib() -> ctypes.CDLL:
    """The built ``sparse_mixing`` library with its argument types bound
    (builds on first use)."""
    global _SPARSE_LIB
    if _SPARSE_LIB is None:
        handle = _build.load("sparse_mixing")
        handle.repro_sparse_row_groups.argtypes = [_I, _LL, _I]
        handle.repro_sparse_row_groups.restype = _I
        handle.repro_sparse_mix_aggregate.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _P]
        handle.repro_sparse_mix_aggregate.restype = _I
        _SPARSE_LIB = handle
    return _SPARSE_LIB


def dtype_code(X: torch.Tensor) -> int:
    code = _DTYPES.get(X.dtype)
    if code is None:
        raise TypeError(f"mixing kernels take float32 or bfloat16 payloads, "
                        f"got {X.dtype}")
    return code


def check_cuda_operand(t: torch.Tensor, name: str, device: torch.device,
                       dtype=None, ndim: int = None) -> None:
    """The kernels take contiguous tensors on X's device; raise otherwise."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the payload on {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch_args(X: torch.Tensor):
    """``(device ordinal, stream pointer)``: launches go on PyTorch's
    current stream of X's device."""
    return (X.device.index,
            ctypes.c_void_p(torch.cuda.current_stream(X.device).cuda_stream))
