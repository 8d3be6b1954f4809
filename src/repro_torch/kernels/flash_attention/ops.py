"""The model stack's flash-attention entry point (port of
``repro.kernels.flash_attention.ops``): the (B, S, H, hd) layout around
the kernels' (B, H, S, hd) one, and the gradient.

The kernels take the model's tensors as strided (B, H, S, hd) views and
write their outputs into (B, S, H, hd) buffers, so nothing is copied on
either side of them and the results are (B, S, H, hd)-contiguous.  A
head dim the kernels are not built at (zamba2's 80) is padded with zeros
to the next one and sliced back: copies on both sides.

``flash_attention`` is differentiable, under ``torch.func`` transforms
too (the federated training path: ``vmap`` over clients of ``grad``,
inside ``models/remat.py``'s recomputation).  The forward saves q, k,
v, its output and each row's log-sum-exp; the backward rebuilds the
softmax weights from them (``flash_attention_bwd_cuda``).  Both are
``autograd.Function``s with a ``vmap`` rule that folds the vmapped axis
into the batch, so one launch covers every client (the kernels are
ctypes calls on raw pointers and cannot take batched tensors).  The
Pallas kernel has no ``custom_vjp``; the backward kernels replace none.

A CPU tensor runs the kernels' plain versions
(``ref.flash_attention_ref``, ``ref.flash_attention_bwd_ref``), a CUDA
tensor the kernels (``flash_attention.flash_attention_cuda``,
``flash_attention_bwd_cuda``) or an error; there is no override and no
fallback.  The backward kernels take bf16 only: the gradient of an fp32
call on the card raises.  The reference's TPU knobs are gone: no
padding of S to block multiples (the kernels mask a ragged S), no
``bq``/``bk`` (the tiles are the kernels' own), no ``interpret``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import (check_shapes, flash_attention_bwd_cuda,
                              flash_attention_cuda)
from .ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = ["flash_attention"]


def _fold(t: torch.Tensor, dim: Optional[int], n: int) -> torch.Tensor:
    """A vmapped tensor's ``n`` slices (at ``dim``; broadcast if None)
    folded into its leading (batch) axis."""
    t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(-1, *t.shape[2:])


def _unfold(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.reshape(n, -1, *t.shape[1:])


class _FlashAttention(torch.autograd.Function):
    """(out (B,S,Hq,hd) contiguous, lse (B,Hq,S) fp32) of q (B,S,Hq,hd),
    k/v (B,S,Hkv,hd).  ``lse`` is not differentiable; it is empty for an
    fp32 call on the card (the CUDA-core forward keeps none, and the
    backward kernels take bf16)."""

    @staticmethod
    def forward(q, k, v, causal, window):
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if q.is_cuda and q.dtype == torch.bfloat16:
            out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                            window=window, with_lse=True)
        elif q.is_cuda:
            out = flash_attention_cuda(q, k, v, causal=causal, window=window)
            lse = out.new_empty(*q.shape[:2], 0, dtype=torch.float32)
        else:
            check_shapes(q, k, v, window, None)
            out, lse = flash_attention_ref(q, k, v, causal=causal,
                                           window=window, with_lse=True)
        # the kernel's output is already (B, S, H, hd) in memory: no copy
        # (unless its head dim was padded)
        return out.transpose(1, 2).contiguous(), lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, ctx.causal, ctx.window = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)

    @staticmethod
    def backward(ctx, grad_out, _grad_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionBwd.apply(q, k, v, out, lse, grad_out,
                                              ctx.causal, ctx.window)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window):
        n = info.batch_size
        q, k, v = (_fold(t, d, n) for t, d in zip((q, k, v), in_dims))
        out, lse = _FlashAttention.apply(q, k, v, causal, window)
        return (_unfold(out, n), _unfold(lse, n)), (0, 0)


class _FlashAttentionBwd(torch.autograd.Function):
    """(dq, dk, dv), each contiguous in its operand's (B,S,H,hd) layout,
    of ``_FlashAttention``'s saved tensors and its output's gradient.
    First derivatives only."""

    @staticmethod
    def forward(q, k, v, out, lse, grad_out, causal, window):
        q, k, v, out, grad_out = (t.transpose(1, 2) for t in (
            q, k, v, out, grad_out.contiguous()))
        if q.is_cuda:
            grads = flash_attention_bwd_cuda(q, k, v, out, lse, grad_out,
                                             causal=causal, window=window)
        else:
            grads = flash_attention_bwd_ref(q, k, v, out, lse, grad_out,
                                            causal=causal, window=window)
        return tuple(g.transpose(1, 2).contiguous() for g in grads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash_attention has first derivatives "
                                  "only")

    @staticmethod
    def vmap(info, in_dims, q, k, v, out, lse, grad_out, causal, window):
        n = info.batch_size
        args = (_fold(t, d, n) for t, d in zip(
            (q, k, v, out, lse, grad_out), in_dims))
        grads = _FlashAttentionBwd.apply(*args, causal, window)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B,S,Hq,hd), k/v (B,S,Hkv,hd) -> (B,S,Hq,hd), contiguous, and
    differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, causal, window)[0]
