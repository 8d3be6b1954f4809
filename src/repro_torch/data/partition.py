"""Non-i.i.d. federated partitioning (paper Sec. 6.1.3).

The paper's scheme: sort all samples by label, split into ``2n`` equal
chunks, assign each of the ``n`` clients exactly two chunks -- so each client
ends up with (at most) two labels.  "This results in extreme data
heterogeneity."  A Dirichlet partitioner is provided for milder regimes.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .synthetic import Dataset

__all__ = ["label_sorted_partition", "dirichlet_partition", "iid_partition"]


def label_sorted_partition(ds: Dataset, n_clients: int,
                           shards_per_client: int = 2,
                           rng: np.random.Generator | None = None
                           ) -> List[np.ndarray]:
    """Paper's pathological non-iid split: sort by label, chunk, deal
    ``shards_per_client`` chunks per client.  Returns per-client index
    arrays."""
    rng = rng or np.random.default_rng(0)
    order = np.argsort(np.asarray(ds.y), kind="stable")
    n_shards = n_clients * shards_per_client
    usable = (len(order) // n_shards) * n_shards
    shards = np.split(order[:usable], n_shards)
    perm = rng.permutation(n_shards)
    return [np.concatenate([shards[perm[c * shards_per_client + s]]
                            for s in range(shards_per_client)])
            for c in range(n_clients)]


def dirichlet_partition(ds: Dataset, n_clients: int, alpha: float = 0.5,
                        rng: np.random.Generator | None = None
                        ) -> List[np.ndarray]:
    """Label-Dirichlet split: per class, proportions ~ Dir(alpha)."""
    rng = rng or np.random.default_rng(0)
    y = np.asarray(ds.y)
    out: List[List[int]] = [[] for _ in range(n_clients)]
    for c in np.unique(y):
        idx = np.nonzero(y == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for client, part in enumerate(np.split(idx, cuts)):
            out[client].extend(part.tolist())
    return [np.array(sorted(o), dtype=np.int64) for o in out]


def iid_partition(ds: Dataset, n_clients: int,
                  rng: np.random.Generator | None = None) -> List[np.ndarray]:
    rng = rng or np.random.default_rng(0)
    perm = rng.permutation(len(ds))
    usable = (len(perm) // n_clients) * n_clients
    return list(np.split(perm[:usable], n_clients))
