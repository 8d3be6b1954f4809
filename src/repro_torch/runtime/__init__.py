"""repro_torch.runtime: wall-clock ingestion on top of the virtual-time
engines (port of ``repro.runtime``).

``IngestEngine`` (selected by ``ExecutionConfig(stream=...,
runtime=RuntimeConfig(...))``) runs semi-async FL rounds against real
threads and real (scaled) latency, records the measured traffic, and
emits a ``Recording`` whose virtual-time replay through ``StreamEngine``
reproduces the live ``History`` bitwise -- see
``repro_torch.runtime.ingest`` for the guarded-commit rule that makes the
anchor hold.  ``queueing``, ``workers`` and ``clock`` are the reference's
numpy / standard-library modules, carried here as the port's own copies.
"""

from .clock import Clock, VirtualClock, WallClock
from .ingest import CLOCK_KINDS, IngestEngine, RuntimeConfig
from .queueing import DROP_POLICIES, Upload, UploadQueue
from .recorder import (Recording, TrafficRecorder, history_digest,
                       params_sha256, slice_trace)
from .workers import ClientPool

__all__ = [
    "CLOCK_KINDS", "DROP_POLICIES",
    "Clock", "VirtualClock", "WallClock",
    "ClientPool", "Upload", "UploadQueue",
    "IngestEngine", "RuntimeConfig",
    "Recording", "TrafficRecorder",
    "history_digest", "params_sha256", "slice_trace",
]
