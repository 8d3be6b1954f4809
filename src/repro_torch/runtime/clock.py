"""Clock abstraction: one scheduler body, two notions of time (port of
``repro.runtime.clock``).

The ingestion engine (``repro_torch.runtime.ingest``) runs the SAME
closure arithmetic as the virtual-time ``StreamEngine`` -- the shared
``repro_torch.fl.stream.closure_time`` / ``consume_arrivals``
functions.  What
varies is where arrival positions come from, and that is the ``Clock``:

``VirtualClock``
    Arrivals are known at dispatch (the plan's ``arrival_t`` column), so
    every upload "lands" immediately and the guarded-commit loop passes
    on its first iteration -- the engine degenerates to ``StreamEngine``
    bitwise.  ``dispatch`` is a no-op, ``drain`` always empty.

``WallClock``
    Arrivals are *measured*: ``dispatch`` hands the cohort to a
    ``ClientPool`` (training workers + latency timers), ``drain`` pops
    landed uploads off the shared ``UploadQueue``, and ``offset``
    converts a landing's wall timestamp into the virtual-time unit the
    closure rule speaks (``(wall - dispatch_wall) / time_scale``,
    rounded to float32 exactly like a recorded ``arrival_t`` column, so
    live closure decisions and replay see the same number).
    ``lower_offset`` is the elapsed time since a cohort's dispatch --
    a lower bound on any still-in-flight upload's eventual offset, which
    is what makes the guarded commit sound (float32 round-to-nearest is
    monotone, so the final measured offset can never round below the
    bound taken earlier).
"""

from __future__ import annotations

import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .queueing import Upload, UploadQueue
from .workers import ClientPool

__all__ = ["Clock", "VirtualClock", "WallClock"]


class Clock:
    """Scheduler-facing time source (see module docstring)."""

    is_wall: bool = False

    def __init__(self):
        self._start = time.monotonic()

    def elapsed(self) -> float:
        """Wall seconds since construction (the ``wall_budget`` check --
        real seconds even in virtual mode, so a budget bounds CI jobs
        regardless of clock kind)."""
        return time.monotonic() - self._start

    def dispatch(self, t: int, sched: Sequence[Tuple[int, float]],
                 train_fn: Optional[Callable] = None,
                 ordered: bool = False) -> Optional[Future]:
        raise NotImplementedError

    def drain(self) -> Tuple[List[Upload], List[Upload]]:
        raise NotImplementedError

    def wait(self, timeout: float) -> None:
        raise NotImplementedError

    def finish(self) -> None:
        raise NotImplementedError


class VirtualClock(Clock):
    """Degenerate clock: time is the virtual closure variable itself.
    Nothing runs concurrently; the engine reads arrivals straight from
    the plan at dispatch, exactly like ``StreamEngine``."""

    is_wall = False

    def dispatch(self, t, sched, train_fn=None, ordered=False):
        # training payloads evaluate synchronously on the server thread
        # in virtual mode; there is nothing to overlap with
        return None

    def drain(self):
        return [], []

    def wait(self, timeout):
        return None

    def finish(self):
        return None


class WallClock(Clock):
    """Real time, scaled: one virtual time unit = ``time_scale`` wall
    seconds.  Owns the upload queue and the client pool."""

    is_wall = True

    def __init__(self, time_scale: float, workers: int = 4,
                 queue_capacity: Optional[int] = None,
                 drop_policy: str = "block"):
        super().__init__()
        self.time_scale = float(time_scale)
        self.queue = UploadQueue(capacity=queue_capacity,
                                 policy=drop_policy)
        self.pool = ClientPool(self.queue, time_scale=self.time_scale,
                               workers=workers)
        self._d_wall: Dict[int, float] = {}

    def prime(self, fn: Callable[[], Any]) -> None:
        """Run ``fn`` once on every training thread of the pool
        (``ClientPool.prime``), then restart ``elapsed`` (the priming is
        set-up, not run time)."""
        self.pool.prime(fn)
        self._start = time.monotonic()

    def dispatch(self, t, sched, train_fn=None, ordered=False):
        wall0, fut = self.pool.dispatch(t, sched, train_fn=train_fn,
                                        ordered=ordered)
        self._d_wall[t] = wall0
        return fut

    def offset(self, r: int, wall_ts: float) -> np.float32:
        """Measured virtual-time offset of a wall timestamp relative to
        cohort ``r``'s dispatch -- float32, the recorded arrival."""
        return np.float32((wall_ts - self._d_wall[r]) / self.time_scale)

    def lower_offset(self, r: int) -> np.float32:
        """Elapsed virtual time since cohort ``r``'s dispatch: a lower
        bound on every still-in-flight upload's eventual offset."""
        return self.offset(r, time.monotonic())

    def drain(self):
        return self.queue.drain()

    def wait(self, timeout):
        self.queue.wait(timeout)

    def finish(self):
        self.pool.finish()
