"""The runtime's profiler ranges (``repro_torch.core.spans``) and
``LocalEngine.staged_bytes``.

With no profiler recording, ``span`` never opens a ``record_function``
range.  Under ``torch.profiler`` one ``FederatedServer.run`` of K rounds
gives each range its count, all on the calling thread inside the run.
``staged_bytes`` counts the bytes moved to the engine's device: on the
``meta`` device every host tensor moves, on the CPU none does.  Two
clients, a quadratic loss, K = 2 rounds.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import topology
from repro_torch.core import spans
from repro_torch.core.pytree import tree_leaves
from repro_torch.core.server import FederatedServer, ServerConfig
from repro_torch.fl.engine import ExecutionConfig, LocalEngine
from repro_torch.fl.plan import RoundPlan

N, T, B, P, K = 2, 2, 2, 3, 2


def quad_loss(params, batch):
    b, = batch
    return 0.5 * torch.sum((params["x"] - b.mean(dim=0)) ** 2)


def _sampler(rng, t):
    return (torch.from_numpy(rng.standard_normal((N, T, B, P))
                             .astype(np.float32)),)


def _network_config():
    network = topology.make_spec("k_regular", n=N, c=1, k_range=(1, 1),
                                 p_fail=0.0).build()
    cfg = ServerConfig(T=T, t_max=K, phi_max=1.0, bound_kind="regular",
                       seed=0, eta=lambda t: 0.05)
    return network, cfg


def _server(**execution):
    network, cfg = _network_config()
    return FederatedServer(network, quad_loss, {"x": torch.zeros(P)},
                           _sampler, cfg, device="cpu",
                           execution=ExecutionConfig(**execution))


def test_no_range_opens_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no "
                             "profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert spans.span(spans.NAMES[0]) is spans.span(spans.NAMES[1])
    server = _server()
    server.run()
    server.run(plan=RoundPlan.connectivity_aware(server.network,
                                                 server.config))


@pytest.mark.parametrize("planned,scan", [(True, False), (False, True)],
                         ids=["plan_passed", "server_plans_scanned"])
def test_each_range_once_per_layer_crossing(tmp_path, planned, scan):
    server = _server(scan=scan)
    plan = (RoundPlan.connectivity_aware(server.network, server.config)
            if planned else None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.run"):
            server.run(plan=plan)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    run, = [e for e in events if e["name"] == "test.run"]
    ours = [e for e in events if e["name"] in spans.NAMES]
    counts = {name: sum(e["name"] == name for e in ours)
              for name in spans.NAMES}
    assert counts == {"repro_torch.plan": 0 if planned else 1,
                      "repro_torch.batches": 1, "repro_torch.stage": 1,
                      "repro_torch.local_sgd": K,
                      "repro_torch.mix_update": K}
    for e in ours:
        assert e["cat"] == "user_annotation"
        assert e["tid"] == run["tid"]
        assert run["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= run["ts"] + run["dur"]


def test_staged_bytes_counts_what_moves_to_the_device():
    network, cfg = _network_config()
    plan = RoundPlan.connectivity_aware(network, cfg)
    rng = np.random.default_rng(0)
    batches = [_sampler(rng, t) for t in range(K)]
    params = {"x": torch.zeros(P)}
    host = sum(x.nbytes for x in tree_leaves((params, batches)))
    # the plan's fp32 columns: A (K, n, n), tau (K, n), m (K,), eta (K,)
    columns = 4 * (K * N * N + K * N + K + K)

    meta = LocalEngine(quad_loss, ExecutionConfig(), device="meta")
    meta.execute(plan, params, batches)
    assert meta.staged_bytes == host + columns
    meta.execute(plan, params, batches)
    assert meta.staged_bytes == 2 * (host + columns)
    # already on the device: nothing moves
    on_device = LocalEngine(quad_loss, ExecutionConfig(), device="meta")
    staged = on_device._stage((params, batches))
    assert on_device.staged_bytes == host
    on_device.execute(plan, *staged)
    assert on_device.staged_bytes == host + columns
    cpu = LocalEngine(quad_loss, ExecutionConfig(), device="cpu")
    cpu.execute(plan, params, batches)
    assert cpu.staged_bytes == 0
