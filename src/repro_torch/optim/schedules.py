"""Learning-rate schedules (pure-Python copy of ``repro.optim.schedules``),
including the paper's two schedules:

* Sec. 6.1.3 experimental schedule:  eta_t = 0.02 * 0.1^t (t = global round)
* Theorem 4.5 theory schedule:       eta_t = 4 / (T mu (t + t1))
"""

from __future__ import annotations

import math
from typing import Callable

__all__ = ["constant", "exponential", "paper_experimental", "inverse_time",
           "cosine", "warmup_cosine"]

Schedule = Callable[[int], float]


def constant(lr: float) -> Schedule:
    return lambda t: lr


def exponential(lr0: float, decay: float) -> Schedule:
    return lambda t: lr0 * (decay ** t)


def paper_experimental() -> Schedule:
    """The paper's simulation schedule (Sec. 6.1.3)."""
    return exponential(0.02, 0.1)


def inverse_time(c: float, t1: float) -> Schedule:
    """eta_t = c / (t + t1) -- the Theorem 4.5 family."""
    return lambda t: c / (t + t1)


def cosine(lr0: float, total: int, lr_min: float = 0.0) -> Schedule:
    def f(t: int) -> float:
        frac = min(max(t / max(total, 1), 0.0), 1.0)
        return lr_min + 0.5 * (lr0 - lr_min) * (1 + math.cos(math.pi * frac))
    return f


def warmup_cosine(lr0: float, warmup: int, total: int,
                  lr_min: float = 0.0) -> Schedule:
    tail = cosine(lr0, max(total - warmup, 1), lr_min)

    def f(t: int) -> float:
        if t < warmup:
            return lr0 * (t + 1) / warmup
        return tail(t - warmup)
    return f
