"""The products of the reference at a chosen precision.

``fp64`` computes in float64 and ``fp32`` in float32, as written.  The
others compute in float32 and round the operands of every matrix product
and convolution, in the forward and the backward pass, as a tensor-core
product in that precision reads them: ``tf32`` keeps 10 mantissa bits
(round to nearest even), ``fp8`` is e4m3 with one scale a tensor (its
largest magnitude at 448).  Put in the program's place, a lower
precision is the control the comparison has to fail.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["PRECISIONS", "compute_dtype", "round_to", "mm", "conv2d"]

PRECISIONS = ("fp64", "fp32", "tf32", "fp8")
_EXACT = ("fp64", "fp32")
_E4M3_MAX = 448.0


def compute_dtype(mode: str) -> torch.dtype:
    return torch.float64 if mode == "fp64" else torch.float32


def round_to(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode in _EXACT:
        return x
    x = x.float()
    if mode == "tf32":
        i = x.contiguous().view(torch.int32)
        lsb = (i >> 13) & 1
        return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    if mode == "fp8":
        scale = x.abs().amax().clamp_min(1e-30) / _E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"precision must be one of {PRECISIONS}, got {mode!r}")


class _Operand(torch.autograd.Function):
    """Rounds a product's operand; its gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, mode):
        return round_to(x, mode)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Result(torch.autograd.Function):
    """Leaves a product's result unchanged and rounds the gradient that
    enters its backward products."""

    @staticmethod
    def forward(ctx, x, mode):
        ctx.mode = mode
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.mode), None


def mm(a: torch.Tensor, b: torch.Tensor, mode: str = "fp32"):
    if mode in _EXACT:
        return a @ b
    return _Result.apply(_Operand.apply(a, mode) @ _Operand.apply(b, mode),
                         mode)


def conv2d(x: torch.Tensor, w: torch.Tensor, padding: int,
           mode: str = "fp32"):
    if mode in _EXACT:
        return F.conv2d(x, w, padding=padding)
    return _Result.apply(F.conv2d(_Operand.apply(x, mode),
                                  _Operand.apply(w, mode), padding=padding),
                         mode)
