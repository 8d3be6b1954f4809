"""Traffic generation: the inputs every cell hands to the program and to
the reference alike, made from the seed.

``make_classification`` and ``label_sorted_partition`` copy the
arithmetic of ``repro_torch.data`` (the paper's MNIST-shaped synthetic
images and its two-shards-a-client split, Sec. 6.1.3), so the benchmark
owns its inputs.  ``block_seed`` derives one block's seed from the run's
seed and the block's index: every seed gives every block the same sizes,
and only the draws differ.
"""

from __future__ import annotations

import numpy as np

__all__ = ["block_seed", "make_classification", "label_sorted_partition"]


def block_seed(seed: int, *path: int) -> int:
    """A 32-bit seed for the stream at ``path`` under the run's ``seed``
    (any non-negative integer, past 64 bits too)."""
    return int(np.random.SeedSequence([int(seed), *map(int, path)])
               .generate_state(1)[0])


def make_classification(n_samples: int, seed: int, n_classes: int = 10,
                        image_hw: int = 28, noise: float = 0.35):
    """Class-structured images (prototype + sinusoid texture + noise):
    ``(x (N, hw, hw, 1) float32, y (N,) int32)``."""
    rng = np.random.default_rng(seed)
    hw = image_hw
    protos = rng.standard_normal((n_classes, hw, hw)).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
    for c in range(n_classes):
        fx, fy = 1 + c % 3, 1 + (c // 3) % 3
        protos[c] = (np.sin(2 * np.pi * fx * xx / hw + c)
                     + np.cos(2 * np.pi * fy * yy / hw - c)
                     + 0.3 * protos[c])
    y = rng.integers(0, n_classes, size=n_samples)
    x = protos[y] + noise * rng.standard_normal(
        (n_samples, hw, hw)).astype(np.float32)
    return x[..., None].astype(np.float32), y.astype(np.int32)


def label_sorted_partition(y: np.ndarray, n_clients: int,
                           shards_per_client: int,
                           rng: np.random.Generator):
    """Sort by label, cut into ``n_clients * shards_per_client`` chunks,
    deal each client ``shards_per_client`` of them: per-client index
    arrays."""
    order = np.argsort(np.asarray(y), kind="stable")
    n_shards = n_clients * shards_per_client
    usable = (len(order) // n_shards) * n_shards
    shards = np.split(order[:usable], n_shards)
    perm = rng.permutation(n_shards)
    return [np.concatenate([shards[perm[c * shards_per_client + s]]
                            for s in range(shards_per_client)])
            for c in range(n_clients)]
