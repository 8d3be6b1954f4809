"""Communication / energy accounting (paper Sec. 6.2).

The paper reports ``cost = (#D2S transmissions) + ratio * (#D2D
transmissions)`` with ``ratio = E_D2D / E_Glob = 0.1`` (a pessimistic value
in favor of D2S).  D2S transmissions are client uplinks (one per sampled
client per round); D2D transmissions are directed edge activations (one per
non-self-loop edge per D2D aggregation round).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

__all__ = ["CommLedger", "count_d2d_transmissions"]

DEFAULT_ENERGY_RATIO = 0.1


def count_d2d_transmissions(W: np.ndarray) -> int:
    """Directed transmissions in one cluster round = #edges minus self-loops
    (a client 'sending to itself' costs nothing)."""
    W = np.asarray(W)
    return int(W.sum() - np.trace(W))


@dataclasses.dataclass
class CommLedger:
    """Per-round communication log with the paper's energy model."""

    energy_ratio: float = DEFAULT_ENERGY_RATIO
    d2s_per_round: List[int] = dataclasses.field(default_factory=list)
    d2d_per_round: List[int] = dataclasses.field(default_factory=list)

    def add_round(self, d2s: int, d2d: int) -> None:
        self.d2s_per_round.append(int(d2s))
        self.d2d_per_round.append(int(d2d))

    @property
    def total_d2s(self) -> int:
        return int(sum(self.d2s_per_round))

    @property
    def total_d2d(self) -> int:
        return int(sum(self.d2d_per_round))

    @property
    def total_cost(self) -> float:
        return self.total_d2s + self.energy_ratio * self.total_d2d

    def cumulative_cost(self) -> np.ndarray:
        d2s = np.cumsum(self.d2s_per_round, dtype=np.float64)
        d2d = np.cumsum(self.d2d_per_round, dtype=np.float64)
        return d2s + self.energy_ratio * d2d
