"""Faults planted in the program's timed path, for the tests that see
``correct`` come out false and for reading each fault's numbers on the
chip (``run.py --calibrate``): each replaces
``repro_torch.core.rounds.client_deltas``, which the round functions look
up at call time, until the context exits."""

from __future__ import annotations

import contextlib

__all__ = ["FAULTS", "planted"]


def _unchanged(orig):
    """A step that returns its state unchanged: every delta zero."""
    def client_deltas(loss_fn, global_params, client_batches, eta):
        out = orig(loss_fn, global_params, client_batches, eta)
        return {k: _zeros(v) for k, v in out.items()} \
            if isinstance(out, dict) else out
    return client_deltas


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return tree * 0


def _half_batch(orig):
    """Half of each local batch left out, the mean taken over the rest:
    the first half of the batch axis, or of the sequence where the batch
    holds one row."""
    def half(b):
        if b.shape[2] >= 2:                      # (n, T, B, ...)
            return b[:, :, : b.shape[2] // 2]
        return b[..., : b.shape[-1] // 2]

    def client_deltas(loss_fn, global_params, client_batches, eta):
        return orig(loss_fn, global_params,
                    tuple(half(b) for b in client_batches), eta)
    return client_deltas


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch}


@contextlib.contextmanager
def planted(name: str):
    from repro_torch.core import rounds

    orig = rounds.client_deltas
    rounds.client_deltas = FAULTS[name](orig)
    try:
        yield
    finally:
        rounds.client_deltas = orig
