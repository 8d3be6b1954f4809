"""The model stack's flash-attention entry point (port of
``repro.kernels.flash_attention.ops``): the (B, S, H, hd) layout around
the kernel's (B, H, S, hd) one.

The kernel takes the model's tensors as strided (B, H, S, hd) views and
writes its output into a (B, S, H, hd) buffer, so nothing is copied on
either side of it and the result is (B, S, H, hd)-contiguous.  A head
dim the kernels are not built at (zamba2's 80) is padded with zeros to
the next one and sliced back: copies on both sides.

A CPU tensor runs the kernel's plain version
(``ref.flash_attention_ref``), a CUDA tensor the kernel
(``flash_attention.flash_attention_cuda``) or an error; there is no
override and no fallback.  The reference's TPU knobs are gone: no
padding of S to block multiples (the kernel masks a ragged S), no
``bq``/``bk`` (the tiles are the kernel's own), no ``interpret``.

The kernel is forward-only, as the Pallas one is (it has no
``custom_vjp``), so a backward pass through ``flash_attention`` raises
instead of differentiating the plain version, and a call inside a
``torch.func`` transform raises at once: training attends with ``ref``
or ``chunked``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import check_shapes, flash_attention_cuda
from .ref import flash_attention_ref

__all__ = ["flash_attention"]


class _FlashForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if q.is_cuda:
            out = flash_attention_cuda(q, k, v, causal=causal, window=window)
        else:
            check_shapes(q, k, v, window, None)
            out = flash_attention_ref(q, k, v, causal=causal, window=window)
        # the kernel's output is already (B, S, H, hd) in memory: no copy
        # (unless its head dim was padded)
        return out.transpose(1, 2).contiguous()

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(_FORWARD_ONLY)


_FORWARD_ONLY = ("flash_attention is forward-only, as the reference's "
                 "Pallas kernel is: training attends with attn_impl='ref' "
                 "or 'chunked', as the reference's does")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B,S,Hq,hd), k/v (B,S,Hkv,hd) -> (B,S,Hq,hd), contiguous.
    Refused inside a ``torch.func`` transform (``grad`` / ``vmap``, the
    federated training path)."""
    from torch._C._functorch import get_interpreter_stack

    if get_interpreter_stack():
        raise NotImplementedError(_FORWARD_ONLY)
    return _FlashForward.apply(q, k, v, causal, window)
