"""What the port's round loops keep live on the device.

A round's mixed deltas (the round function's second output) are freed
before the next round starts, in ``LocalEngine.execute`` sequentially
and scanned; the one-pass backends ('aggregate', 'fused') free the packed
payload before the eq.-4 epilogue adds the aggregate row to the params.
At a language model's size each of those is several trees of the
model's size (a (n, P) payload), so holding one a round too long is what
runs a card out of memory.  CPU, a quadratic loss on a k-regular plan of
four clients; lifetimes are read through ``weakref`` on the tensors,
which reference counting frees as soon as nothing holds them.
"""

import weakref

import numpy as np
import pytest
import torch

from repro_torch import topology
from repro_torch.core import rounds
from repro_torch.core.pytree import tree_leaves
from repro_torch.core.server import FederatedServer, ServerConfig
from repro_torch.fl import engine, packing
from repro_torch.fl.engine import ExecutionConfig

N, T, B, P, ROUNDS = 4, 2, 2, 300, 3


def quad_loss(params, batch):
    b, = batch
    return 0.5 * torch.sum((params["x"] - b.mean(dim=0)) ** 2)


def _sampler(rng, t):
    return (torch.from_numpy(rng.standard_normal((N, T, B, P))
                             .astype(np.float32)),)


def _server(**execution):
    network = topology.make_spec("k_regular", n=N, c=2, k_range=(1, 2),
                                 p_fail=0.0).build()
    cfg = ServerConfig(T=T, t_max=ROUNDS, phi_max=1.0, bound_kind="regular",
                       seed=0, eta=lambda t: 0.05)
    return FederatedServer(network, quad_loss, {"x": torch.zeros(P)},
                           _sampler, cfg, device="cpu",
                           execution=ExecutionConfig(**execution))


def _watch_rounds(monkeypatch):
    """Wrap every round function the engine builds: each call first
    checks that no tensor of the previous round's mixed deltas is alive,
    then records weak references to its own.  Returns the list of rounds
    whose mixed deltas were recorded."""
    make = rounds.make_round_fn
    seen = []
    live = []

    def make_watched(*args, **kwargs):
        round_fn = make(*args, **kwargs)

        def watched(*a, **kw):
            held = sum(r() is not None for r in live)
            assert held == 0, (f"round {len(seen)}: {held} tensors of the "
                               "previous round's mixed deltas still live")
            out = round_fn(*a, **kw)
            live[:] = [weakref.ref(x) for x in tree_leaves(out[1])]
            seen.append(len(live))
            return out

        return watched

    monkeypatch.setattr(rounds, "make_round_fn", make_watched)
    monkeypatch.setattr(engine, "make_round_fn", make_watched)
    return seen


@pytest.mark.parametrize("scan", [False, True], ids=["sequential", "scanned"])
@pytest.mark.parametrize("backend,record_mixed", [("einsum", False),
                                                  ("fused", True),
                                                  ("pallas", True)])
def test_each_rounds_mixed_deltas_freed_before_the_next(monkeypatch, backend,
                                                        record_mixed, scan):
    seen = _watch_rounds(monkeypatch)
    server = _server(backend=backend, record_mixed=record_mixed, scan=scan)
    server.run()
    assert seen == [1] * ROUNDS    # every round made mixed deltas, one leaf


@pytest.mark.parametrize("backend,launch", [("aggregate", "aggregate_grouped"),
                                            ("fused",
                                             "mix_aggregate_grouped")])
def test_packed_payload_freed_before_the_epilogue(monkeypatch, backend,
                                                  launch):
    kernel = getattr(rounds, launch)
    apply = packing.apply_aggregate_row
    payload, checked = [], []

    def launched(A, tau, m, bufs, **kw):
        payload[:] = [weakref.ref(b) for b in bufs]
        return kernel(A, tau, m, bufs, **kw)

    def epilogue(*args):
        checked.append(sum(r() is not None for r in payload))
        return apply(*args)

    monkeypatch.setattr(rounds, launch, launched)
    monkeypatch.setattr(packing, "apply_aggregate_row", epilogue)
    rng = np.random.default_rng(0)
    params = {"x": torch.zeros(P), "y": torch.zeros(3, 5)}

    def loss(p, batch):
        return quad_loss(p, batch) + 0.5 * torch.sum(p["y"] ** 2)

    A = torch.full((N, N), 1.0 / N)
    new = rounds.make_round_fn(loss, backend)(
        params, _sampler(rng, 0), A, torch.ones(N), torch.tensor(float(N)),
        torch.tensor(0.05))[0]
    assert payload and checked == [0]
    assert torch.isfinite(new["x"]).all() and bool((new["x"] != 0).any())
