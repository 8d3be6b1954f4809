"""Profiler ranges at the runtime's layer boundaries.

``span(name)`` opens a ``torch.profiler.record_function`` range while a
profiler is recording on the calling thread, and does nothing otherwise:
tracing is on exactly while a ``torch.profiler.profile`` runs, with no
flag.  The ranges are host events on the calling thread, on the same
clock as the device events of the exported trace, so the time the device
waits can be put down to the range open around it.  Each sits outside
any loop over clients, leaves or local steps: a few ranges a round.

    repro_torch.plan        building a plan's rows (``RoundPlan``)
    repro_torch.batches     drawing a run's batches on the host
    repro_torch.stage       moving a run's inputs to the engine's device
    repro_torch.local_sgd   one round's local SGD of every client
    repro_torch.mix_update  one round's mixing, aggregation and update
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["NAMES", "span"]

NAMES = ("repro_torch.plan", "repro_torch.batches", "repro_torch.stage",
         "repro_torch.local_sgd", "repro_torch.mix_update")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    shared no-op context (one boolean check)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
