"""Data substrate: synthetic datasets, non-iid partitioning, batch loading."""

from .loader import FederatedBatcher, lm_batches
from .partition import dirichlet_partition, iid_partition, label_sorted_partition
from .synthetic import Dataset, make_classification, make_token_stream

__all__ = [
    "Dataset", "make_classification", "make_token_stream",
    "label_sorted_partition", "dirichlet_partition", "iid_partition",
    "FederatedBatcher", "lm_batches",
]
