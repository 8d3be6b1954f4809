"""Forward flash attention as a hand-written CUDA kernel: the port of
``repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas``.

``csrc/flash_attention.cu`` computes what ``_flash_kernel`` computes, on
the (B, H, S, hd) layout: fp32 online softmax over the key tiles a block
of 64 query rows can see (fully masked tiles beyond the causal diagonal
or before the window are never visited), GQA by indexing (kv head = q
head // group), the causal, sliding-window and kv-tail masks, rows that
see no key set to 0.  Both products run as fp32 FMAs on the CUDA cores
with ``p`` kept in fp32, as the reference keeps it; at qwen2-7b's
prefill shape the work is bound by operations (see the source's header).
There is no padding: the kernel masks a ragged S itself, and its 64 x 64
tiles are its own choice, not the TPU's block sizes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention_cuda", "check_shapes", "HEAD_DIMS"]

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        handle = _build.load("flash_attention")
        P, I = ctypes.c_void_p, ctypes.c_int
        handle.repro_flash_attention.argtypes = [
            P, P, P, P, I, I, I, I, I, I, I, I, I, ctypes.c_float, I, I, P]
        handle.repro_flash_attention.restype = I
        _LIB = handle
    return _LIB


def check_shapes(q, k, v, window, true_seq_k) -> int:
    """Shape checks on any device; returns the masked key length."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Hq, Sq, hd) and k, v one (B, Hkv, "
                         f"Sk, hd); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, _, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or k.shape[1] == 0 or \
            Hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (batch, head dim, Hq % Hkv)")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    Sk = k.shape[2]
    seq_k = Sk if true_seq_k is None else int(true_seq_k)
    if not 0 <= seq_k <= Sk:
        raise ValueError(f"true_seq_k {seq_k} outside [0, {Sk}]")
    return seq_k


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         true_seq_k: Optional[int] = None) -> torch.Tensor:
    """q (B, Hq, Sq, hd), k/v (B, Hkv, Sk, hd), fp32 or bf16, contiguous
    -> (B, Hq, Sq, hd) in q's dtype.  Keys at or past ``true_seq_k`` are
    masked; rows and columns are absolute positions.

    Launches the kernel on the current stream or raises: on a CPU tensor
    (``ops.flash_attention`` sends those to the plain version,
    ``ref.flash_attention_ref``), a head dim other than 32 / 64 / 128,
    another dtype, a non-contiguous or misaligned operand.
    ``flash_attention_cuda.launches`` counts the launches."""
    seq_k = check_shapes(q, k, v, window, true_seq_k)
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda takes CUDA tensors; "
                         "ops.flash_attention runs the plain version on the "
                         "CPU")
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims {HEAD_DIMS}, "
                         f"got {hd}")
    code = _DTYPES.get(q.dtype)
    if code is None:
        raise TypeError(f"the flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned (a fresh tensor is)")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = _lib()
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq, Hkv,
        Sq, Sk, hd, seq_k, int(bool(causal)),
        -1 if window is None else int(window), hd ** -0.5, code,
        q.device.index, stream)
    _build.check(lib, rc, "flash_attention")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0
