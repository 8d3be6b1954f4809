"""Simulated client fleet: training workers + upload latency timers (port
of ``repro.runtime.workers``).

One ``ClientPool`` stands in for the whole client population of a
wall-clock ingestion run (``repro_torch.runtime.ingest``).  Per
dispatched cohort it owns

* optionally one *training job* -- the cohort's payload computed off the
  server thread (overlapping dispatch: round ``t+1`` trains while round
  ``t``'s stragglers drain).  Heterogeneous-optimizer jobs go through a
  dedicated single-worker executor: per-client optimizer state is
  sequential, so payloads MUST evaluate in dispatch order (the same
  order the replay side uses).
* one *timer thread* that sleeps through the cohort's scheduled upload
  latencies (virtual latencies x ``time_scale`` wall seconds, measured
  from payload-ready when a training job exists, else from dispatch) and
  pushes one ``Upload`` per landing into the shared ``UploadQueue``.

``finish`` is the graceful-shutdown flush: timers are woken early and
enqueue their remaining landings immediately (``force=True``, so the
bounded queue cannot drop them), then everything joins.  The engine
relies on this to give every dispatched upload a *finite* measured
arrival -- the recording then replays stragglers into the exact rounds
where the live run evicted them, instead of counting them lost at
dispatch.

Port-side repairs.  ``finish`` joins every thread whatever happens: it
cancels training jobs that have not started, waits for the running
ones, and a timer polls its job's future and the stop flag rather than
blocking on the future alone, so a cancelled job (whose waiters are
never notified) cannot hang a timer.  ``prime`` runs a function once on
every training thread before the clock starts, so per-thread set-up
(a CUDA library handle is made per thread at its first use) is not
timed as upload latency.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import Callable, List, Optional, Sequence, Tuple

from .queueing import Upload, UploadQueue

__all__ = ["ClientPool"]

_POLL = 0.05        # seconds between a timer's looks at its training job


class ClientPool:
    """Thread pool simulating clients that train and upload with real
    (scaled) latency against a shared bounded queue."""

    def __init__(self, queue: UploadQueue, time_scale: float,
                 workers: int = 4):
        if time_scale <= 0:
            raise ValueError(f"time_scale must be > 0, got {time_scale}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.queue = queue
        self.time_scale = time_scale
        self.workers = workers
        self._train = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="repro-client")
        self._ordered = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="repro-hetero")
        self._timers: List[threading.Thread] = []
        self._stop = threading.Event()

    def prime(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` once on each training thread (all ``workers`` of
        the pool and the ordered one), waiting for every call; a call's
        exception is raised here."""
        gate = threading.Barrier(self.workers)

        def held():
            try:
                fn()
            finally:
                gate.wait()      # each call holds its thread: one a thread

        futs = [self._train.submit(held) for _ in range(self.workers)]
        futs.append(self._ordered.submit(fn))
        wait(futs)
        for f in futs:
            f.result()

    def dispatch(self, t: int,
                 sched: Sequence[Tuple[int, float]],
                 train_fn: Optional[Callable] = None,
                 ordered: bool = False
                 ) -> Tuple[float, Optional[Future]]:
        """Launch cohort ``t``: ``sched`` is the ``(client,
        virtual_latency)`` list of finite-latency uploaders.  Returns
        ``(dispatch_wall, payload_future)``; the future is None without
        a training job (non-overlapped dispatch -- the server computes
        the payload lazily at closure, serializing the loop)."""
        wall0 = time.monotonic()
        fut: Optional[Future] = None
        if train_fn is not None:
            fut = (self._ordered if ordered else self._train).submit(
                train_fn)
        if sched:
            th = threading.Thread(
                target=self._run_timers, name=f"repro-timer-{t}",
                args=(t, wall0, sorted(sched, key=lambda s: s[1]), fut),
                daemon=True)
            th.start()
            self._timers.append(th)
        return wall0, fut

    def _run_timers(self, t: int, wall0: float,
                    sched: Sequence[Tuple[int, float]],
                    fut: Optional[Future]) -> None:
        if fut is not None:
            # overlap semantics: a client cannot upload a delta it has
            # not finished computing -- latency runs from payload-ready
            # (training exceptions surface on the server thread, not
            # here)
            while not fut.done() and not self._stop.is_set():
                wait([fut], timeout=_POLL)
            base = time.monotonic()
        else:
            base = wall0
        for client, lat in sched:
            remaining = base + lat * self.time_scale - time.monotonic()
            if remaining > 0 and not self._stop.is_set():
                self._stop.wait(remaining)
            self.queue.put(Upload(round=t, client=client,
                                  wall=time.monotonic()),
                           force=self._stop.is_set())

    def finish(self) -> None:
        """Graceful shutdown: wake every timer, let them flush their
        remaining landings (forced past any capacity limit), cancel the
        training jobs not yet started, and join every thread."""
        self._stop.set()
        self.queue.close()
        try:
            self._train.shutdown(wait=True, cancel_futures=True)
            self._ordered.shutdown(wait=True, cancel_futures=True)
        finally:
            for th in self._timers:
                th.join()
            self._timers.clear()
