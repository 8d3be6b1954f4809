"""Federated batch sampling: minibatches per client per local-SGD step.

The server's round function expects batches with leading axes
``(n_clients, T, batch, ...)`` -- T independent minibatches per client per
global round (one per local SGD iteration, eq. 1).  ``FederatedBatcher``
draws them from the per-client index partitions with replacement across
rounds (standard SGD sampling), consuming the numpy ``Generator`` exactly
as the reference does, and returns CPU tensors that the engine moves to
its device.  ``lm_batches`` draws token-stream minibatches for the
transformer stack.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .synthetic import Dataset

__all__ = ["FederatedBatcher", "lm_batches"]


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


def lm_batches(tokens: np.ndarray, rng: np.random.Generator, n_clients: int,
               T: int, batch_size: int, seq_len: int, device="cpu"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inputs, targets) int32 tensors of shape (n, T, B, seq_len) on
    ``device``, from a token stream; the draws are the reference's, so
    the arrays are bitwise its.

    Clients get disjoint contiguous stream regions (non-iid in n-gram
    statistics since the stream's transition table is position-independent
    but region sampling keeps client batches decorrelated)."""
    n_tok = len(tokens)
    region = n_tok // n_clients
    starts_max = region - seq_len - 1
    if starts_max <= 0:
        raise ValueError("token stream too short for this seq_len")
    xs = np.empty((n_clients, T, batch_size, seq_len), dtype=np.int32)
    ys = np.empty_like(xs)
    for i in range(n_clients):
        base = i * region
        starts = base + rng.integers(0, starts_max, size=(T, batch_size))
        for t in range(T):
            for b in range(batch_size):
                s = starts[t, b]
                xs[i, t, b] = tokens[s:s + seq_len]
                ys[i, t, b] = tokens[s + 1:s + seq_len + 1]
    return (torch.from_numpy(xs).to(device),
            torch.from_numpy(ys).to(device))
