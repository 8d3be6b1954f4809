"""Data substrate: synthetic datasets, non-iid partitioning, batch loading."""

from .loader import FederatedBatcher
from .partition import dirichlet_partition, iid_partition, label_sorted_partition
from .synthetic import Dataset, make_classification

__all__ = [
    "Dataset", "make_classification",
    "label_sorted_partition", "dirichlet_partition", "iid_partition",
    "FederatedBatcher",
]
