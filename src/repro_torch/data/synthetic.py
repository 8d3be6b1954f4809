"""Deterministic synthetic datasets.

``make_classification`` -- MNIST-shaped (28x28x1, 10 classes) image
classification with class-conditional structure (per-class prototype +
noise + per-class frequency texture), hard enough that accuracy tracks
training progress but learnable by the paper's small CNN / MLP.
``make_token_stream`` -- integer LM token streams with local n-gram
structure for the transformer training paths.

Everything is generated from an explicit ``np.random.Generator`` so runs are
reproducible offline (no downloads).
"""

from __future__ import annotations

import dataclasses
import numpy as np

__all__ = ["Dataset", "make_classification", "make_token_stream"]


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


def make_token_stream(n_tokens: int = 1 << 16, vocab: int = 512,
                      order: int = 3, seed: int = 0) -> np.ndarray:
    """Markov token stream: sparse per-context transition structure gives a
    learnable LM signal (loss decreases with training).  The reference's
    draws in the reference's order, so the stream is bitwise its."""
    rng = np.random.default_rng(seed)
    # hash-based sparse transitions: each context maps to 8 candidate tokens
    n_ctx_buckets = 4096
    table = rng.integers(0, vocab, size=(n_ctx_buckets, 8))
    toks = np.empty(n_tokens, dtype=np.int32)
    toks[:order] = rng.integers(0, vocab, size=order)
    mults = np.array([1000003, 10007, 101][:order], dtype=np.int64)
    for i in range(order, n_tokens):
        ctx = int((toks[i - order:i].astype(np.int64) * mults).sum()
                  % n_ctx_buckets)
        if rng.random() < 0.9:
            toks[i] = table[ctx, rng.integers(0, 8)]
        else:
            toks[i] = rng.integers(0, vocab)
    return toks
