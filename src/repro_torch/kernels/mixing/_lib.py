"""ctypes bindings of ``csrc/mixing.cu``, ``csrc/sparse_mixing.cu`` and
``csrc/quant_mixing.cu`` (C ABIs documented there), and the operand checks
the wrappers share."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["ROUTES", "lib", "sparse_lib", "quant_lib", "dtype_code",
           "launch_args", "launch_routed", "check_cuda_operand",
           "check_quant_operands", "check_cuda_quant_operands"]

_LIB = None
_SPARSE_LIB = None
_QUANT_LIB = None
# storage name -> (C code, container dtype, stored bits a value, block unit)
_STORAGES = {"int8": (0, torch.int8, 8, 128),
             "int4": (1, torch.int8, 4, 256),
             "fp8": (2, torch.float8_e4m3fn, 8, 128)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)
# the route repro_mix_aggregate, repro_sparse_mix_aggregate and their
# dequant twins report they took, by its code (the static rule is in the
# sources' headers)
ROUTES = ("generic", "staged")


def lib() -> ctypes.CDLL:
    """The built library with its argument types bound (builds on first
    use)."""
    global _LIB
    if _LIB is None:
        handle = _build.load("mixing")
        handle.repro_aggregate_row_groups.argtypes = [_I, _LL, _I]
        handle.repro_aggregate_row_groups.restype = _I
        handle.repro_aggregate.argtypes = [_P, _P, _P, _P, _I, _LL, _I, _I,
                                           _P]
        handle.repro_aggregate.restype = _I
        handle.repro_mix_aggregate.argtypes = [_P, _P, _P, _P, _I, _I, _LL,
                                               _I, _I, _P, _PI]
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
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _P, _PI]
        handle.repro_sparse_mix_aggregate.restype = _I
        _SPARSE_LIB = handle
    return _SPARSE_LIB


def quant_lib() -> ctypes.CDLL:
    """The built ``quant_mixing`` library with its argument types bound
    (builds on first use)."""
    global _QUANT_LIB
    if _QUANT_LIB is None:
        handle = _build.load("quant_mixing")
        handle.repro_aggregate_dequant_row_groups.argtypes = [_I, _LL, _I]
        handle.repro_aggregate_dequant_row_groups.restype = _I
        handle.repro_aggregate_dequant.argtypes = [
            _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _P]
        handle.repro_aggregate_dequant.restype = _I
        handle.repro_mix_aggregate_dequant.argtypes = [
            _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _P, _PI]
        handle.repro_mix_aggregate_dequant.restype = _I
        handle.repro_sparse_dequant_row_groups.argtypes = [_I, _LL]
        handle.repro_sparse_dequant_row_groups.restype = _I
        handle.repro_sparse_mix_aggregate_dequant.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _P, _PI]
        handle.repro_sparse_mix_aggregate_dequant.restype = _I
        _QUANT_LIB = handle
    return _QUANT_LIB


def check_quant_operands(Xq: torch.Tensor, S: torch.Tensor, storage: str,
                         block: int):
    """Validate a quantized payload's geometry on any device: storage
    name, block, container dtype and ``Xq.shape[1] * 8 // bits ==
    S.shape[1] * block`` (the reference's ``_quant_grid`` without the TPU
    chunk).  Returns ``(storage code, n, p)``."""
    if storage not in _STORAGES:
        raise ValueError(f"storage must be one of {tuple(_STORAGES)}, got "
                         f"{storage!r}")
    code, dtype, bits, unit = _STORAGES[storage]
    if block <= 0 or block % unit:
        raise ValueError(f"block must be a positive multiple of {unit} for "
                         f"{storage!r} storage, got {block}")
    if Xq.dtype != dtype:
        raise TypeError(f"{storage!r} containers must be {dtype}, got "
                        f"{Xq.dtype}")
    if Xq.ndim != 2 or S.ndim != 2 or S.shape[0] != Xq.shape[0]:
        raise ValueError(f"Xq and S must be (n, cols) and (n, blocks), got "
                         f"{tuple(Xq.shape)} and {tuple(S.shape)}")
    n, p = Xq.shape[0], S.shape[1] * block
    if Xq.shape[1] * 8 // bits != p:
        raise ValueError(
            f"Xq holds {Xq.shape[1] * 8 // bits} {storage} values a row but "
            f"S covers {S.shape[1]} blocks of {block} = {p}")
    return code, n, p


def check_cuda_quant_operands(Xq: torch.Tensor, S: torch.Tensor) -> None:
    """The dequant kernels take contiguous operands on one device, fp32
    scales and a 16-byte aligned container buffer."""
    check_cuda_operand(Xq, "Xq", Xq.device)
    check_cuda_operand(S, "S", Xq.device, torch.float32)
    if Xq.data_ptr() % 16:
        raise ValueError("Xq must be 16-byte aligned (a fresh tensor is)")


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


def launch_routed(lib: ctypes.CDLL, entry, args, wrapper) -> None:
    """Call a C entry point that reports its route through a trailing
    ``int*``, raise on a CUDA error, and count the launch on ``wrapper``
    (``.launches`` and ``.routes[ROUTES[code]]``)."""
    route = ctypes.c_int(-1)
    rc = entry(*args, ctypes.byref(route))
    _build.check(lib, rc, wrapper.__name__)
    wrapper.launches += 1
    wrapper.routes[ROUTES[route.value]] += 1
