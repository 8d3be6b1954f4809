"""Federated batch sampling: minibatches per client per local-SGD step.

The server's round function expects batches with leading axes
``(n_clients, T, batch, ...)`` -- T independent minibatches per client per
global round (one per local SGD iteration, eq. 1).  ``FederatedBatcher``
draws them from the per-client index partitions with replacement across
rounds (standard SGD sampling), consuming the numpy ``Generator`` exactly
as the reference does, and returns CPU tensors that the engine moves to
its device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .synthetic import Dataset

__all__ = ["FederatedBatcher"]


class FederatedBatcher:
    def __init__(self, ds: Dataset, parts: List[np.ndarray], T: int,
                 batch_size: int):
        self.ds = ds
        self.parts = parts
        self.T = T
        self.batch_size = batch_size

    @property
    def n_clients(self) -> int:
        return len(self.parts)

    def __call__(self, rng: np.random.Generator, t: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (x, y) with shapes (n, T, B, ...) / (n, T, B)."""
        n, T, B = self.n_clients, self.T, self.batch_size
        xs = np.empty((n, T, B) + self.ds.x.shape[1:], dtype=self.ds.x.dtype)
        ys = np.empty((n, T, B), dtype=self.ds.y.dtype)
        for i, part in enumerate(self.parts):
            idx = rng.choice(part, size=(T, B), replace=True)
            xs[i] = self.ds.x[idx]
            ys[i] = self.ds.y[idx]
        return torch.from_numpy(xs), torch.from_numpy(ys).long()
