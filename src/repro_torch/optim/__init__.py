"""Optimizer substrate (port of ``repro.optim``)."""

from .hetero import (CLIENT_OPTIMIZERS, HeteroClientOptimizers,
                     parse_client_optim)
from .optimizers import (AdamState, Optimizer, adam, adamw,
                         clip_by_global_norm, momentum, sgd)
from .schedules import (constant, cosine, exponential, inverse_time,
                        paper_experimental, warmup_cosine)

__all__ = [
    "Optimizer", "AdamState", "sgd", "momentum", "adam", "adamw",
    "clip_by_global_norm",
    "constant", "exponential", "paper_experimental", "inverse_time",
    "cosine", "warmup_cosine",
    "CLIENT_OPTIMIZERS", "HeteroClientOptimizers", "parse_client_optim",
]
