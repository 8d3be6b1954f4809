"""Bounded upload queue between simulated clients and the server loop
(copy of ``repro.runtime.queueing``).

Client upload timers (``repro_torch.runtime.workers``) ``put`` one
``Upload`` per landing; the ingestion engine ``drain``s them between closure
decisions.  The queue is the backpressure point: with a finite
``capacity`` the server can fall behind the fleet, and the policy says
who pays --

    ``block``        producers wait for space (lossless; the fleet
                     slows to the server's pace)
    ``drop_oldest``  evict the oldest queued upload to admit the new
                     one (bounded memory, fresh data wins)
    ``reject``       refuse the new upload (bounded memory, old data
                     wins)

Dropped uploads never reach the server's pending maps: their recorded
arrival stays ``inf``, so a replay of the recording counts them ``lost``
at their dispatch round, while the live History bills them in the round
whose gather observed the drop -- the one documented live/replay
telemetry divergence (see ``repro_torch.runtime.ingest``).  Drops are
additionally itemized in ``Recording.meta['drops']``.

The queue is deliberately free of any engine or torch knowledge so the
drop policies are testable synchronously (no threads) with a seeded load
generator.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, List, Optional, Tuple

__all__ = ["DROP_POLICIES", "Upload", "UploadQueue"]

DROP_POLICIES = ("block", "drop_oldest", "reject")


@dataclasses.dataclass(frozen=True)
class Upload:
    """One landed client upload: cohort round, client id, and the wall
    timestamp (``time.monotonic`` seconds) at which it entered the
    queue."""
    round: int
    client: int
    wall: float


class UploadQueue:
    """Thread-safe bounded FIFO of ``Upload``s with a drop policy."""

    def __init__(self, capacity: Optional[int] = None,
                 policy: str = "block"):
        if policy not in DROP_POLICIES:
            raise ValueError(
                f"policy must be one of {DROP_POLICIES}, got {policy!r}")
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.policy = policy
        self._q: Deque[Upload] = deque()
        self._dropped: List[Upload] = []
        self._cond = threading.Condition()
        self._closed = False

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    def put(self, upload: Upload, force: bool = False) -> bool:
        """Enqueue one upload.  Returns False iff *this* upload was
        rejected (``reject`` policy at capacity).  ``force=True``
        bypasses capacity entirely -- the shutdown flush uses it so the
        final drain is lossless."""
        with self._cond:
            if (not force and self.capacity is not None
                    and len(self._q) >= self.capacity):
                if self.policy == "reject":
                    self._dropped.append(upload)
                    self._cond.notify_all()
                    return False
                if self.policy == "drop_oldest":
                    self._dropped.append(self._q.popleft())
                else:   # block: wait for the server to drain
                    while (len(self._q) >= self.capacity
                           and not self._closed):
                        self._cond.wait(timeout=0.05)
            self._q.append(upload)
            self._cond.notify_all()
            return True

    def drain(self) -> Tuple[List[Upload], List[Upload]]:
        """Pop everything queued so far.  Returns ``(landed, dropped)``
        in arrival order; both lists are cleared from the queue."""
        with self._cond:
            landed = list(self._q)
            self._q.clear()
            dropped = self._dropped
            self._dropped = []
            self._cond.notify_all()
            return landed, dropped

    def wait(self, timeout: float) -> None:
        """Block until something is queued (landed or dropped) or
        ``timeout`` seconds pass."""
        with self._cond:
            if self._q or self._dropped:
                return
            self._cond.wait(timeout=timeout)

    def close(self) -> None:
        """Unblock any producer stuck in the ``block`` policy (shutdown
        path); subsequent blocking puts fall through immediately."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
