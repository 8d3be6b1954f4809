"""Faults planted in the program's timed path, for the tests that see
``correct`` come out false and for reading each fault's numbers on the
chip (``run.py --calibrate``).  Each replaces a function that the
program looks up at call time, until the context exits: on one card
``repro_torch.core.rounds.client_deltas``; on a mesh
(``planted(..., mesh=True)``) the mesh runtime's ``local_sgd`` and
``_mix_and_aggregate`` in ``repro_torch.fl.distributed``.  ``FAULTS``
are the one card's, ``MESH_FAULTS`` the mesh's: the same two, and the
exchange between clients left out."""

from __future__ import annotations

import contextlib

__all__ = ["FAULTS", "MESH_FAULTS", "names", "planted"]


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


def _mesh_unchanged(orig):
    """The rank's local SGD returns its start: its delta zero."""
    def local_sgd(loss_fn, params, batches, eta):
        orig(loss_fn, params, batches, eta)
        return params
    return local_sgd


def _mesh_half_batch(orig):
    """``_half_batch`` on one client's (T, B, ...) batches."""
    def half(b):
        if b.shape[1] >= 2:
            return b[:, : b.shape[1] // 2]
        return b[..., : b.shape[-1] // 2]

    def local_sgd(loss_fn, params, batches, eta):
        return orig(loss_fn, params, tuple(half(b) for b in batches), eta)
    return local_sgd


class _Alone:
    """``torch.distributed`` as the mixing schedules call it, with every
    exchange between clients left out: a rank gathers copies of its own
    row, reduces and scatters its own values, and receives what it
    sends."""

    def __init__(self, dist):
        self._dist = dist

    def __getattr__(self, name):
        return getattr(self._dist, name)

    def all_reduce(self, tensor, group=None, **kw):
        return None

    def all_gather_into_tensor(self, out, send, group=None, **kw):
        out.copy_(send.expand(out.shape))

    def reduce_scatter_tensor(self, part, front, group=None, **kw):
        r, n = self._dist.get_rank(group), part.shape[0]
        part.copy_(front[r * n:(r + 1) * n])

    def batch_isend_irecv(self, ops):
        send = next(o.tensor for o in ops if o.op is self._dist.isend)
        recv = next(o.tensor for o in ops if o.op is self._dist.irecv)
        recv.copy_(send)
        return []


def _no_exchange(orig):
    """The mixing and aggregation with no collective between clients."""
    def _mix_and_aggregate(*a, **kw):
        from repro_torch.fl import distributed
        real = distributed.dist
        distributed.dist = _Alone(real)
        try:
            return orig(*a, **kw)
        finally:
            distributed.dist = real
    return _mix_and_aggregate


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch}
# on a mesh: name -> (the function of ``fl.distributed`` replaced, the
# fault)
MESH_FAULTS = {"unchanged": ("local_sgd", _mesh_unchanged),
               "half_batch": ("local_sgd", _mesh_half_batch),
               "no_exchange": ("_mix_and_aggregate", _no_exchange)}


def names(mesh: bool = False):
    """The faults a cell on one card, or on a mesh, can have."""
    return sorted(MESH_FAULTS if mesh else FAULTS)


@contextlib.contextmanager
def planted(name: str, mesh: bool = False):
    if mesh:
        from repro_torch.fl import distributed as mod
        attr, make = MESH_FAULTS[name]
    else:
        from repro_torch.core import rounds as mod
        attr, make = "client_deltas", FAULTS[name]
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)
