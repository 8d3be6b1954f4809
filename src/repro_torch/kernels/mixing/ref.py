"""Plain PyTorch versions of the graph-mixing kernels (paper eq. 3 + 4).

``Delta = A @ X`` where ``A`` (n, n) is the (block-diagonal, column-
stochastic) equal-neighbor matrix over clients and ``X`` (n, p) holds each
client's flattened scaled cumulative gradient; ``agg = w @ X`` with the
precombined D2S row ``w = (tau^T A) / m``; the sparse versions take ``A``
in ELL form (``idx``, ``w`` of shape (n, d_max)).  Every product
accumulates in fp32 whatever X's dtype.  The kernel wrappers
(``mixing.mix_cuda``, ``fused.aggregate_cuda``, ``fused.mix_aggregate_cuda``,
``sparse.sparse_mix_cuda``, ``sparse.sparse_mix_aggregate_cuda``) run these
for CPU tensors, and ``chip_smoke.py`` holds each kernel against them on
the card.

The ``_dequant_`` versions take a quantized payload in its wire format
(``repro_torch.fl.packing.QuantSpec``): stored containers ``Xq`` (int8,
nibble-packed int4, or float8_e4m3fn) and fp32 per-block scales ``S``.
Each dequantizes (``dequant_ref``) and then runs the plain version above;
their outputs are fp32 (the dequant kernels'
``fused.aggregate_dequant_cuda``, ``fused.mix_aggregate_dequant_cuda``,
``sparse.sparse_mix_aggregate_dequant_cuda``).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["mix_ref", "aggregate_ref", "mix_aggregate_ref", "sparse_mix_ref",
           "sparse_mix_aggregate_ref", "dequant_ref", "aggregate_dequant_ref",
           "mix_aggregate_dequant_ref", "sparse_mix_aggregate_dequant_ref"]


def mix_ref(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """A (n, n) float; X (n, p) any float dtype -> (n, p) in X.dtype."""
    return (A.float() @ X.float()).to(X.dtype)


def aggregate_ref(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """w (n,) f32; X (n, p) -> the (p,) f32 row ``w @ X``."""
    return w.float() @ X.float()


def mix_aggregate_ref(A: torch.Tensor, w: torch.Tensor, X: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(A @ X in X.dtype, w @ X in f32)``."""
    return mix_ref(A, X), aggregate_ref(w, X)


def sparse_mix_ref(idx: torch.Tensor, w: torch.Tensor, X: torch.Tensor
                   ) -> torch.Tensor:
    """ELL gather ``mixed[i] = sum_k w[i, k] * X[idx[i, k]]``: idx (n, d_max)
    integer, w (n, d_max) float, X (n, p) -> (n, p) in X.dtype.

    The reference's ``_gather_mix`` slot loop unrolled: fp32 accumulation
    in slot order ``k = 0 .. d_max - 1``, padding slots (index 0, weight
    0.0) included, each product and sum rounded to fp32."""
    x = X.float()
    w = w.float()
    idx = idx.long()
    acc = torch.zeros_like(x)
    for k in range(idx.shape[1]):
        acc = acc + w[:, k, None] * x[idx[:, k]]
    return acc.to(X.dtype)


def sparse_mix_aggregate_ref(idx: torch.Tensor, w: torch.Tensor,
                             wrow: torch.Tensor, X: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sparse_mix_ref(idx, w, X), wrow @ X in f32)``."""
    return sparse_mix_ref(idx, w, X), aggregate_ref(wrow, X)


def dequant_ref(Xq: torch.Tensor, S: torch.Tensor, storage: str,
                block: int) -> torch.Tensor:
    """``deq(Xq, S)[i, c] = float(v[i, c]) * S[i, c // block]`` in fp32,
    one rounded product per value: ``v`` is the int8 value, the
    sign-extended nibble (low nibble = even column) for 'int4', or the
    e4m3 value for 'fp8'.  Bitwise ``packing.dequantize_group``."""
    if storage == "int4":
        lo = (Xq << 4) >> 4
        hi = Xq >> 4
        v = torch.stack([lo, hi], dim=-1).reshape(Xq.shape[0], -1)
    else:
        v = Xq
    n, nb = S.shape
    x = v.float().reshape(n, nb, block) * S.float()[:, :, None]
    return x.reshape(n, nb * block)


def aggregate_dequant_ref(w: torch.Tensor, Xq: torch.Tensor,
                          S: torch.Tensor, storage: str, block: int
                          ) -> torch.Tensor:
    """The (p,) f32 row ``w @ deq(Xq, S)``."""
    return aggregate_ref(w, dequant_ref(Xq, S, storage, block))


def mix_aggregate_dequant_ref(A: torch.Tensor, w: torch.Tensor,
                              Xq: torch.Tensor, S: torch.Tensor,
                              storage: str, block: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(A @ x, w @ x)`` over ``x = deq(Xq, S)``, both f32."""
    return mix_aggregate_ref(A, w, dequant_ref(Xq, S, storage, block))


def sparse_mix_aggregate_dequant_ref(idx: torch.Tensor, w: torch.Tensor,
                                     wrow: torch.Tensor, Xq: torch.Tensor,
                                     S: torch.Tensor, storage: str,
                                     block: int
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ELL gather and ``wrow @ x`` over ``x = deq(Xq, S)``, both f32;
    the gather keeps ``sparse_mix_ref``'s slot loop (product and sum
    rounded apart)."""
    return sparse_mix_aggregate_ref(idx, w, wrow,
                                    dequant_ref(Xq, S, storage, block))
