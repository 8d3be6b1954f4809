"""Plain PyTorch versions of the graph-mixing kernels (paper eq. 3 + 4).

``Delta = A @ X`` where ``A`` (n, n) is the (block-diagonal, column-
stochastic) equal-neighbor matrix over clients and ``X`` (n, p) holds each
client's flattened scaled cumulative gradient; ``agg = w @ X`` with the
precombined D2S row ``w = (tau^T A) / m``.  Every product accumulates in
fp32 whatever X's dtype.  The kernel wrappers (``mixing.mix_cuda``,
``fused.aggregate_cuda``, ``fused.mix_aggregate_cuda``) run these for CPU
tensors, and ``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["mix_ref", "aggregate_ref", "mix_aggregate_ref"]


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
