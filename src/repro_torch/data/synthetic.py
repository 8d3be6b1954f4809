"""Deterministic synthetic datasets.

``make_classification`` -- MNIST-shaped (28x28x1, 10 classes) image
classification with class-conditional structure (per-class prototype +
noise + per-class frequency texture), hard enough that accuracy tracks
training progress but learnable by the paper's small CNN / MLP.  (The
reference's LM token streams come with the LM-zoo slice of the port.)

Everything is generated from an explicit ``np.random.Generator`` so runs are
reproducible offline (no downloads).
"""

from __future__ import annotations

import dataclasses
import numpy as np

__all__ = ["Dataset", "make_classification"]


@dataclasses.dataclass(frozen=True)
class Dataset:
    x: np.ndarray          # features, (N, ...)
    y: np.ndarray          # labels, (N,)

    def __len__(self) -> int:
        return len(self.y)

    def subset(self, idx: np.ndarray) -> "Dataset":
        return Dataset(self.x[idx], self.y[idx])


def make_classification(n_samples: int = 7000, n_classes: int = 10,
                        image_hw: int = 28, noise: float = 0.35,
                        seed: int = 0) -> Dataset:
    """Class-structured images: prototype + sinusoid texture + noise."""
    rng = np.random.default_rng(seed)
    hw = image_hw
    protos = rng.standard_normal((n_classes, hw, hw)).astype(np.float32)
    # low-frequency per-class texture so classes are separable by conv nets
    yy, xx = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
    for c in range(n_classes):
        fx, fy = 1 + c % 3, 1 + (c // 3) % 3
        protos[c] = (np.sin(2 * np.pi * fx * xx / hw + c)
                     + np.cos(2 * np.pi * fy * yy / hw - c)
                     + 0.3 * protos[c])
    y = rng.integers(0, n_classes, size=n_samples)
    x = protos[y] + noise * rng.standard_normal(
        (n_samples, hw, hw)).astype(np.float32)
    x = x[..., None].astype(np.float32)          # (N, H, W, 1)
    return Dataset(x=x, y=y.astype(np.int32))
