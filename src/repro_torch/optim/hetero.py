"""Per-client optimizer heterogeneity (port of ``repro.optim.hetero``).

The paper's local step is plain SGD for every client (eq. 1), which is
why ``client_deltas`` can vmap one optimizer over the whole population.
Real fleets are heterogeneous: phones run SGD, workstations run Adam.
This module generalizes the local-training step to a *per-client*
optimizer assignment drawn from the ``repro_torch.optim`` zoo, with
per-client optimizer state carried across cohorts.

Determinism contract (what makes heterogeneous runs replayable): the
assignment is a pure function of the spec string and ``n``
(``parse_client_optim``), clients are grouped by optimizer (groups sorted
by name) and each group runs one ``torch.func.vmap`` over a client's
T-step loop -- so given the same dispatch-order sequence of ``(snapshot,
batches, eta)`` inputs, the produced deltas and the evolved states are
bitwise identical.

``deltas`` advances the state of EVERY client each call, whether or not
that client's upload is later consumed -- consumption is a server-side
decision the client cannot see.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch.func import grad, vmap

from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.fl.engine import _to_device, resolve_device, set_fp32_policy

from .optimizers import Optimizer, adam, adamw, momentum, sgd

__all__ = ["CLIENT_OPTIMIZERS", "HeteroClientOptimizers",
           "parse_client_optim"]

PyTree = Any

# name -> zero-arg factory (defaults only: the assignment string stays a
# flat comma list, JSON-trivial and order-stable)
CLIENT_OPTIMIZERS: Dict[str, Callable[[], Optimizer]] = {
    "sgd": sgd,
    "momentum": momentum,
    "adam": adam,
    "adamw": adamw,
}


def parse_client_optim(spec: str, n: int) -> Tuple[str, ...]:
    """``'sgd'`` | ``'adam'`` | ``'sgd,adam,...'`` -> per-client names.

    A single name assigns every client that optimizer; a comma list is
    dealt round-robin by client index (``names[i % len(names)]``), so
    the assignment is a pure function of ``(spec, n)`` and identical on
    the live and replay sides.
    """
    names = [s.strip() for s in str(spec).split(",") if s.strip()]
    if not names:
        raise ValueError(f"empty client_optim spec {spec!r}")
    for name in names:
        if name not in CLIENT_OPTIMIZERS:
            raise ValueError(
                f"unknown client optimizer {name!r}; available: "
                f"{tuple(sorted(CLIENT_OPTIMIZERS))}")
    return tuple(names[i % len(names)] for i in range(n))


class HeteroClientOptimizers:
    """Stateful heterogeneous local-training runner on one device
    (``cuda`` unless ``device`` is given; ``fl.engine.resolve_device``),
    in full fp32 on the card (``fl.engine.set_fp32_policy``).

    Clients are grouped by optimizer name; each group owns one vmapped
    T-step runner and a stacked per-client state tree.  ``deltas``
    computes every client's local-update delta ``x_i^(T) - x^(t)``
    against the given snapshot and scatters the group results back into
    one ``(n, ...)``-leading tree (the same layout ``client_deltas``
    returns, so the packing/aggregation layers are unchanged).
    """

    def __init__(self, loss_fn, params: PyTree,
                 assignment: Sequence[str], device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_fp32_policy()   # the numerics of a CUDA LocalEngine
        self.assignment = tuple(assignment)
        self.n = len(self.assignment)
        if self.n < 1:
            raise ValueError("need at least one client")
        by_name: Dict[str, List[int]] = {}
        for i, name in enumerate(self.assignment):
            if name not in CLIENT_OPTIMIZERS:
                raise ValueError(f"unknown client optimizer {name!r}")
            by_name.setdefault(name, []).append(i)
        # group order: sorted by name -- stable across runs, never
        # dependent on dict insertion order of the spec string
        self._groups: List[Tuple[str, torch.Tensor]] = [
            (name, torch.as_tensor(by_name[name], dtype=torch.long,
                                   device=self.device))
            for name in sorted(by_name)]
        params = _to_device(params, self.device)
        self._runners = {}
        self._states: Dict[str, PyTree] = {}
        for name, idx in self._groups:
            opt = CLIENT_OPTIMIZERS[name]()
            self._runners[name] = _group_runner(opt, loss_fn)
            st0 = opt.init(params)
            g = int(idx.shape[0])
            self._states[name] = tree_map(lambda x: torch.stack([x] * g),
                                          st0)

    def _inputs(self, global_params, round_batches, eta):
        return (_to_device(global_params, self.device),
                _to_device(round_batches, self.device),
                torch.as_tensor(eta, dtype=torch.float32,
                                device=self.device))

    def warmup(self, global_params: PyTree, round_batches: PyTree,
               eta) -> None:
        """Run every group runner once without advancing any state (the
        runners are pure; ``deltas`` is what commits state), then wait
        for the device, so that a caller's clock started afterwards
        measures no first-call latency."""
        gp, rb, lr = self._inputs(global_params, round_batches, eta)
        for name, idx in self._groups:
            batches_g = tree_map(lambda b: b[idx], rb)
            self._runners[name](gp, batches_g, self._states[name], lr)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def states(self) -> Dict[str, PyTree]:
        """Per-group stacked optimizer states (leading axis = group
        size); read-only view for tests/checkpointing."""
        return dict(self._states)

    def deltas(self, global_params: PyTree, round_batches: PyTree,
               eta) -> PyTree:
        """One local-training round for all ``n`` clients.

        ``round_batches`` leaves are ``(n, T, ...)``.  Returns the delta
        tree with leading axis ``n`` (param dtypes preserved) and
        advances every group's optimizer state in place.
        """
        gp, rb, lr = self._inputs(global_params, round_batches, eta)
        out = tree_map(lambda p: torch.zeros((self.n,) + tuple(p.shape),
                                             dtype=p.dtype,
                                             device=self.device), gp)
        for name, idx in self._groups:
            batches_g = tree_map(lambda b: b[idx], rb)
            d, st = self._runners[name](gp, batches_g, self._states[name],
                                        lr)
            self._states[name] = st
            out = tree_map(lambda o, dd: o.index_copy(0, idx, dd), out, d)
        return out


def _group_runner(opt: Optimizer, loss_fn):
    """One optimizer's vmapped T-step local-training function:
    ``(snapshot, batches_g, states_g, lr) -> (deltas_g, states_g')``
    with group-leading axes on batches/states/deltas."""
    grad_fn = grad(loss_fn)

    def run_one(gp, b, st, lr):
        p, s = gp, st
        for t in range(tree_leaves(b)[0].shape[0]):
            g = grad_fn(p, tree_map(lambda x: x[t], b))
            p, s = opt.update(g, s, p, lr)
        delta = tree_map(lambda f, g0: f - g0, p, gp)
        return delta, s

    def run_group(gp, batches_g, states_g, lr):
        return vmap(run_one, in_dims=(None, 0, 0, None))(
            gp, batches_g, states_g, lr)

    return run_group
