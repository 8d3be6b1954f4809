"""Flash attention as hand-written CUDA kernels: the forward is the port
of ``repro/kernels/flash_attention/flash_attention.py::
flash_attention_pallas``; the backward replaces none (the Pallas kernel
is forward-only) and was added so that LM training attends through the
kernels instead of fp32 score passes.

``csrc/flash_attention.cu`` computes what ``_flash_kernel`` computes, on
(B, H, S, hd) views: fp32 online softmax over the key tiles a block of
query rows can see (fully masked tiles beyond the causal diagonal or
before the window are never visited), GQA by indexing (kv head = q head
// group), the causal, sliding-window and kv-tail masks, rows that see no
key set to 0.  The dtype picks the kernel (``ROUTES``):

* bfloat16 -> ``"tensor_cores"``: Q K^T and P V on ``wgmma`` from a TMA
  ring of K/V tiles, ``p`` split into bf16 hi + lo terms so that it keeps
  ~16 mantissa bits through the PV product; on request it also writes
  each row's log-sum-exp (``with_lse``), which the backward needs;
* float32 -> ``"cuda_cores"``: both products as fp32 FMAs with ``p`` in
  fp32, as the reference's fp32 tolerance needs.

``csrc/flash_attention_bwd.cu`` is the backward
(``flash_attention_bwd_cuda``, bf16 only): two deterministic kernels on
the tensor cores, one for dQ (which also writes ``D = rowsum(dO * O)``)
and one for dK and dV (summed over a kv head's group of q heads in a
fixed order), the weights rebuilt from the saved log-sum-exp; no float
atomics, so two calls give the same bits.

Operands are taken by strides: any view whose last axis is contiguous and
whose base and other strides are 16-byte aligned (what TMA and 16-byte
loads need), such as the model's (B, S, H, hd) projections transposed to
(B, H, S, hd).  Outputs are written into (B, S, H, hd) buffers and
returned as their (B, H, S, hd) transposed views, so the model's layout
needs no copy on either side.  S is not padded: the kernels mask a
ragged S themselves, and their tiles are their own choice, not the
TPU's block sizes.

The kernels are instantiated at head dims 32, 64 and 128 (``HEAD_DIMS``).
Any other head dim up to 128 (zamba2's 80) runs on the next instantiated
one: the operands are copied into zeroed (B, S, H, hd_pad) buffers
(``padded_head_dim``, ``pad_head_dim``), the kernels scale the dot
products by the true ``hd ** -0.5``, and the outputs are the first hd
columns of their padded buffers.  The zero columns add nothing to q . k
(nor to dO . v) and give output columns that are sliced away, so the
results are the unpadded function's.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda",
           "check_shapes", "padded_head_dim", "pad_head_dim", "HEAD_DIMS",
           "ROUTES"]

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel the library reports it launched, by its route code
ROUTES = ("cuda_cores", "tensor_cores")
_LIB = None
_LIB_BWD = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        handle = _build.load("flash_attention")
        P, I = ctypes.c_void_p, ctypes.c_int
        handle.repro_flash_attention.argtypes = [
            P, P, P, P, P, ctypes.POINTER(ctypes.c_longlong), I, I, I, I, I,
            I, I, I, I, ctypes.c_float, I, I, P, ctypes.POINTER(I)]
        handle.repro_flash_attention.restype = I
        _LIB = handle
    return _LIB


def _lib_bwd() -> ctypes.CDLL:
    global _LIB_BWD
    if _LIB_BWD is None:
        handle = _build.load("flash_attention_bwd")
        P, I = ctypes.c_void_p, ctypes.c_int
        handle.repro_flash_attention_bwd.argtypes = [
            P, P, P, P, P, P, P, P, P, P, ctypes.POINTER(ctypes.c_longlong),
            I, I, I, I, I, I, I, I, I, ctypes.c_float, I, P]
        handle.repro_flash_attention_bwd.restype = I
        _LIB_BWD = handle
    return _LIB_BWD


def check_shapes(q, k, v, window, true_seq_k) -> int:
    """Shape, stride and alignment checks on any device; returns the
    masked key length.  Each operand's last axis must be contiguous, its
    base 16-byte aligned and its other strides multiples of 16 bytes
    (TMA's rules; the fp32 kernel's float4 rows need the same)."""
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)
    Sk = k.shape[2]
    seq_k = Sk if true_seq_k is None else int(true_seq_k)
    if not 0 <= seq_k <= Sk:
        raise ValueError(f"true_seq_k {seq_k} outside [0, {Sk}]")
    return seq_k


def _check_layout(name: str, t: torch.Tensor) -> None:
    if t.numel() == 0:
        return
    if t.stride(3) != 1 and t.shape[3] > 1:
        raise ValueError(f"{name}'s last axis must be contiguous, got "
                         f"strides {t.stride()}")
    nbytes = t.element_size()
    if t.data_ptr() % 16 or any(
            t.stride(d) * nbytes % 16 for d in range(3) if t.shape[d] > 1):
        raise ValueError(f"{name} must have a 16-byte aligned base and "
                         f"(batch, head, row) strides of multiples of "
                         f"16 bytes; got strides {t.stride()} of "
                         f"{nbytes}-byte elements")


def padded_head_dim(hd: int) -> int:
    """The instantiated head dim the kernels run ``hd`` at: the smallest
    of ``HEAD_DIMS`` that holds it."""
    for h in HEAD_DIMS:
        if hd <= h:
            return h
    raise ValueError(f"the flash kernel takes head dims up to "
                     f"{HEAD_DIMS[-1]}, got {hd}")


def pad_head_dim(t: torch.Tensor, hd_pad: int) -> torch.Tensor:
    """(B, H, S, hd) -> its values in the first hd columns of a zeroed
    (B, S, H, hd_pad) buffer, as that buffer's (B, H, S, hd_pad) view (the
    model's layout, aligned as the kernels need)."""
    B, H, S, hd = t.shape
    buf = t.new_zeros(B, S, H, hd_pad)
    buf[..., :hd] = t.transpose(1, 2)
    return buf.transpose(1, 2)


def _strides(t: torch.Tensor):
    """(batch, head, row) strides in elements; a size-1 axis (never
    stepped) gets hd, which keeps the kernels' alignment rules."""
    return [t.stride(d) if t.shape[d] > 1 else t.shape[3] for d in range(3)]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         true_seq_k: Optional[int] = None,
                         with_lse: bool = False):
    """q (B, Hq, Sq, hd), k/v (B, Hkv, Sk, hd), fp32 or bf16 strided views
    (``check_shapes``) -> (B, Hq, Sq, hd) in q's dtype, the transposed
    view of a (B, Sq, Hq, hd)-contiguous buffer (of a (B, Sq, Hq,
    hd_pad) one when hd is padded to ``padded_head_dim(hd)``).  Keys at
    or past ``true_seq_k`` are masked; rows and columns are absolute
    positions.  With ``with_lse`` (bf16 only) it returns ``(o, lse)``,
    lse (B, Hq, Sq) fp32 contiguous: each row's log-sum-exp of its
    visible scaled scores, ``-inf`` for a row that sees no key.

    Launches the kernel of q's dtype (``ROUTES``) on the current stream or
    raises: on a CPU tensor (``ops.flash_attention`` sends those to the
    plain version, ``ref.flash_attention_ref``), a head dim over 128,
    another dtype, a misaligned operand.
    ``flash_attention_cuda.launches`` counts the launches and
    ``flash_attention_cuda.routes`` counts them by the kernel the library
    reports it launched."""
    seq_k = check_shapes(q, k, v, window, true_seq_k)
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda takes CUDA tensors; "
                         "ops.flash_attention runs the plain version on the "
                         "CPU")
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    hd_run = padded_head_dim(hd)
    code = _DTYPES.get(q.dtype)
    if code is None:
        raise TypeError(f"the flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if with_lse and q.dtype != torch.bfloat16:
        raise TypeError("only the bf16 (tensor-core) kernel writes the "
                        "log-sum-exp")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
    if hd_run != hd:
        q, k, v = (pad_head_dim(t, hd_run) for t in (q, k, v))
    o = torch.empty(B, Sq, Hq, hd_run, dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty(B, Hq, Sq, dtype=torch.float32,
                      device=q.device) if with_lse else None
    if o.numel():
        lib = _lib()
        strides = (ctypes.c_longlong * 12)(
            *(s for t in (q, k, v, o) for s in _strides(t)))
        route = ctypes.c_int(-1)
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(q.device).cuda_stream)
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), strides, B,
            Hq, Hkv, Sq, Sk, hd_run, seq_k, int(bool(causal)),
            -1 if window is None else int(window), hd ** -0.5, code,
            q.device.index, stream, ctypes.byref(route))
        _build.check(lib, rc, "flash_attention")
        flash_attention_cuda.launches += 1
        flash_attention_cuda.routes[ROUTES[route.value]] += 1
    o = o[..., :hd]
    return (o, lse) if with_lse else o


flash_attention_cuda.launches = 0
flash_attention_cuda.routes = dict.fromkeys(ROUTES, 0)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             true_seq_k: Optional[int] = None):
    """The gradient of ``flash_attention_cuda``: q, o, do (B, Hq, Sq, hd)
    and k/v (B, Hkv, Sk, hd) bf16 strided views (``check_shapes``), lse
    (B, Hq, Sq) fp32 contiguous, the forward's -> (dq, dk, dv), each the
    transposed view of a (B, S, H, hd)-contiguous bf16 buffer; dk and dv
    sum over each kv head's group of q heads.

    Launches the dQ kernel, then the dK/dV kernel, on the current stream
    or raises (CPU tensors, another dtype, a head dim over 128, a
    misaligned operand).  ``flash_attention_bwd_cuda.launches`` counts
    the calls: each launches both kernels once."""
    seq_k = check_shapes(q, k, v, window, true_seq_k)
    if not q.is_cuda:
        raise ValueError("flash_attention_bwd_cuda takes CUDA tensors; "
                         "ops.flash_attention runs the plain version on the "
                         "CPU")
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} is not q's shape "
                             f"{tuple(q.shape)}")
        _check_layout(name, t)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise TypeError(f"the backward kernels take bf16 on one device;"
                            f" {name} is {t.dtype} on {t.device}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous fp32 (B, Hq, Sq) tensor "
                         f"on q's device; got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    hd_run = padded_head_dim(hd)
    if hd_run != hd:
        q, k, v, o, do = (pad_head_dim(t, hd_run) for t in (q, k, v, o, do))

    def out(S, H):
        return torch.empty(B, S, H, hd_run, dtype=q.dtype,
                           device=q.device).transpose(1, 2)

    dq, dk, dv = out(Sq, Hq), out(Sk, Hkv), out(Sk, Hkv)
    if q.numel() == 0 or k.numel() == 0:
        return tuple(t.zero_()[..., :hd] for t in (dq, dk, dv))
    delta = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
    lib = _lib_bwd()
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, o, do, dq, dk, dv) for s in _strides(t)))
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    rc = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), strides, B, Hq, Hkv, Sq, Sk, hd_run,
        seq_k, int(bool(causal)), -1 if window is None else int(window),
        hd ** -0.5, q.device.index, stream)
    _build.check(lib, rc, "flash_attention_bwd")
    flash_attention_bwd_cuda.launches += 1
    return dq[..., :hd], dk[..., :hd], dv[..., :hd]


flash_attention_bwd_cuda.launches = 0
