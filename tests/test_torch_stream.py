"""The semi-async runtime of the port (``repro_torch.fl.stream``: the
closure rule, ``StreamEngine.execute`` / ``execute_controlled``, the
stream matrix of ``make_engine``, ``launch.stream``) against the JAX
reference on the CPU, at a small size (n = 12 clients in c = 2
clusters, a quadratic loss of 4 parameters, 6-8 rounds).

Planning, fault sampling and the closure rule are host numpy in both
packages and draw ``default_rng(seed)`` in the same order, so the
closure times, each round's History record -- its ``stream`` telemetry
(deadline hits, late / lost / duplicate counts, staleness, the weighted
divisor, the shortfall) included -- and the realized plan must be
*equal*.  Params are ``allclose`` to the reference's with ``rtol=1e-4,
atol=1e-5`` (XLA and torch reduce in different orders, and stale rounds
carry fp32 differences forward).  Each scenario of the reference's
``tests/test_stream_engine.py`` has a twin here: pristine, zero-latency
faults, a deadline shortfall, departures, duplicates, buffered late
stragglers, ``client_optim`` and ``execute_controlled``.  Then the
port's own pins: a pristine stream equals ``LocalEngine`` bitwise, a
zero-latency trace equals ``LocalEngine`` on ``plan.with_faults``, a
fault trajectory replays from JSON, ``weights=1.0`` is ``None``, the
snapshots a run trains against stay unchanged, and the CLI.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import topology as jtopology
from repro.core.server import FederatedServer as JServer
from repro.core.server import ServerConfig as JServerConfig
from repro.fl import ExecutionConfig as JExec
from repro.fl import FaultSpec as JFaultSpec
from repro.fl import RoundPlan as JRoundPlan
from repro.fl import StreamConfig as JStreamConfig
from repro.fl import make_engine as jmake_engine
from repro.fl import stream as jstream
from repro_torch import topology
from repro_torch.core.server import FederatedServer, ServerConfig
from repro_torch.fl import packing
from repro_torch.fl import stream as tstream
from repro_torch.fl.engine import ExecutionConfig, LocalEngine, make_engine
from repro_torch.fl.faults import FaultSpec, sample_trace
from repro_torch.fl.plan import RoundPlan
from repro_torch.fl.stream import StreamConfig, StreamEngine
from repro_torch.kernels.mixing.ops import combine_weights
from repro_torch.launch import stream as stream_cli

jax.config.update("jax_enable_x64", False)

N, C, P, T = 12, 2, 4, 3
TOL = dict(rtol=1e-4, atol=1e-5)
SPEC = dict(n=N, c=C, k_range=(4, 6), p_fail=0.1)

# (id, rounds, StreamConfig fields, FaultSpec fields or None): the
# reference's tests/test_stream_engine.py scenarios, plus an 'exp'
# discount with a short max_staleness
SCENARIOS = [
    ("pristine", 6, {}, None),
    ("zero_latency_faults", 6, dict(fault_seed=11),
     dict(failures="markov", failure_params={"p_fail": 0.3,
                                             "p_recover": 0.5})),
    ("deadline_shortfall", 6, dict(deadline=1.0, max_staleness=0),
     dict(latency="fixed", latency_params={"value": 5.0})),
    ("departures", 8, dict(fault_seed=3), dict(depart_rate=0.2)),
    ("duplicates", 6, dict(fault_seed=2), dict(duplicate_rate=0.9)),
    ("buffered_late", 6, dict(buffer=4, deadline=2.0, staleness="poly",
                              fault_seed=9),
     dict(latency="exponential", latency_params={"mean": 1.2})),
    ("mixed_faults", 6, dict(buffer=6, deadline=1.0, staleness="poly",
                             staleness_param=0.5, fault_seed=5),
     dict(failures="iid", failure_params={"rate": 0.2},
          latency="exponential", latency_params={"mean": 0.8},
          duplicate_rate=0.2, depart_rate=0.02)),
    ("exp_short_staleness", 6, dict(buffer=5, deadline=0.7,
                                    staleness="exp", staleness_param=0.6,
                                    max_staleness=2, fault_seed=4),
     dict(failures="iid", failure_params={"rate": 0.1}, latency="uniform",
          latency_params={"lo": 0.0, "hi": 1.4})),
]


def quad_loss(params, batch):
    x = params["x"]
    b, = batch
    return 0.5 * torch.sum((x - b.mean(dim=0)) ** 2)


def jquad_loss(params, batch):
    x = params["x"]
    b, = batch
    return 0.5 * jnp.sum((x - b.mean(axis=0)) ** 2)


def _streams(stream_kw, fault_kw):
    """The same policy as the port's and the reference's StreamConfig."""
    out = []
    for S, F in ((StreamConfig, FaultSpec), (JStreamConfig, JFaultSpec)):
        faults = None if fault_kw is None else F(**fault_kw)
        out.append(S(faults=faults, **stream_kw))
    return out


def _problem(K=6, seed=3):
    """The plan (port and reference), params and batches made from seeds
    with numpy."""
    cfg = dict(T=T, t_max=K, phi_max=0.3, seed=seed, eta=lambda t: 0.2)
    plan = RoundPlan.connectivity_aware(
        topology.make_spec("k_regular", **SPEC).build(), ServerConfig(**cfg))
    jplan = JRoundPlan.connectivity_aware(
        jtopology.make_spec("k_regular", **SPEC).build(),
        JServerConfig(**cfg))
    assert plan.to_json() == jplan.to_json()
    rng = np.random.default_rng(7)
    targets = rng.standard_normal((N, P)).astype(np.float32)
    samples = [(targets[:, None, None, :]
                + 0.05 * rng.standard_normal((N, T, 2, P)))
               .astype(np.float32) for _ in range(K)]
    return (plan, {"x": torch.zeros(P)},
            [(torch.as_tensor(s),) for s in samples],
            jplan, {"x": jnp.zeros(P)}, [(jnp.asarray(s),) for s in samples])


def _digest(h):
    """Every field of every record but ``metrics`` (nan psi as a string:
    nan != nan), and the ledger totals."""
    rows = [(r.t, r.m, r.m_actual,
             "nan" if math.isnan(r.psi_bound) else r.psi_bound,
             r.d2s, r.d2d, r.eta, r.stream, r.control) for r in h.records]
    return rows, h.ledger.total_d2s, h.ledger.total_d2d


def _close(p, jp):
    np.testing.assert_allclose(p["x"].numpy(), np.asarray(jp["x"]), **TOL)


def _runs(backend, stream_kw, fault_kw, K, trace=False):
    plan, params, batches, jplan, jparams, jbatches = _problem(K)
    S, JS = _streams(stream_kw, fault_kw)
    eng = make_engine(ExecutionConfig(backend=backend, stream=S),
                      quad_loss, device="cpu")
    jeng = jmake_engine(JExec(backend=backend, stream=JS), jquad_loss)
    p, h = eng.execute(plan, params, batches)
    jp, jh = jeng.execute(jplan, jparams, jbatches)
    return (eng, p, h), (jeng, jp, jh)


# ---------------------------------------------------------------------------
# the shared host functions: equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,param", [("none", 0.5), ("poly", 0.5),
                                        ("poly", 1.3), ("exp", 0.6)])
def test_staleness_weight_equals_the_reference(kind, param):
    for s in range(8):
        assert tstream.staleness_weight(s, kind, param) == \
            jstream.staleness_weight(s, kind, param)
    with pytest.raises(ValueError):
        tstream.staleness_weight(1, "nope")


@pytest.mark.parametrize("buffer,deadline", [(None, math.inf), (None, 0.9),
                                             (3, math.inf), (5, 1.1),
                                             (40, 0.2)])
def test_closure_and_consumption_equal_the_reference(buffer, deadline):
    """Random cohort books from a seed: both packages' closure_time and
    consume_arrivals decide the same C_t, the same groups and weights,
    and leave the same pending entries."""
    rng = np.random.default_rng(17)
    for trial in range(20):
        t = int(rng.integers(1, 6))
        now = float(rng.uniform(0.0, 3.0))
        books = {}
        for r in range(max(0, t - 3), t + 1):
            pend = {int(i): float(now - rng.uniform(-2.0, 1.5))
                    for i in rng.choice(N, size=int(rng.integers(0, 6)),
                                        replace=False)}
            books[r] = (pend, set(pend) | {int(rng.integers(N))})
        outs = []
        for mod, S in ((tstream, tstream.StreamConfig), (jstream,
                                                          JStreamConfig)):
            cfg = S(buffer=buffer, deadline=deadline, staleness="poly")
            cohorts = {r: mod._Cohort(t=r, snapshot=None,
                                      pending=dict(p), expected=set(e))
                       for r, (p, e) in books.items()}
            C_t, hit = mod.closure_time(cohorts, t, now, cfg)
            consumed = mod.consume_arrivals(cohorts, t, C_t, cfg)
            outs.append((C_t, hit, consumed,
                         {r: c.pending for r, c in cohorts.items()}))
        assert outs[0] == outs[1], trial


# ---------------------------------------------------------------------------
# the reference's scenarios, twinned
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["einsum", "fused"])
@pytest.mark.parametrize("name,K,stream_kw,fault_kw", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_stream_scenario_equals_the_reference(name, K, stream_kw, fault_kw,
                                              backend):
    (eng, p, h), (jeng, jp, jh) = _runs(backend, stream_kw, fault_kw, K)
    assert eng.backend == jeng.backend
    assert _digest(h) == _digest(jh)
    assert eng.last_closures == jeng.last_closures
    assert eng.last_realized_plan.to_json() == \
        jeng.last_realized_plan.to_json()
    _close(p, jp)
    streams = [r.stream for r in h.records]
    if name == "pristine":
        assert streams == [None] * K
    if name == "deadline_shortfall":
        assert all(r.m_actual == 0 for r in h.records)
        assert torch.equal(p["x"], torch.zeros(P))
    if name == "departures":
        assert int((eng.last_trace.depart_round < K).sum()) > 0
    if name == "duplicates":
        assert sum(s.get("dup", 0) for s in streams if s) > 0
    if name in ("buffered_late", "mixed_faults", "exp_short_staleness"):
        # the stale path ran: staleness-weighted cohorts were aggregated
        assert any(s and "m_weighted" in s for s in streams)


@pytest.mark.parametrize("backend", ["einsum", "fused"])
def test_client_optim_stream_equals_the_reference(backend):
    stream_kw = dict(buffer=5, deadline=1.0, staleness="poly",
                     client_optim="sgd,adam", fault_seed=9)
    fault_kw = dict(latency="exponential", latency_params={"mean": 1.0})
    (eng, p, h), (jeng, jp, jh) = _runs(backend, stream_kw, fault_kw, 6)
    assert _digest(h) == _digest(jh)
    assert eng.last_closures == jeng.last_closures
    _close(p, jp)


def _server(pkg, stream, backend, K=5, family="k_regular", **spec):
    """A quadratic-loss FederatedServer of either package, the batches
    drawn from the server's own seeded stream."""
    spec = spec or SPEC
    rng = np.random.default_rng(0)
    targets = rng.standard_normal((N, P)).astype(np.float32)
    cfg = dict(T=T, t_max=K, phi_max=0.3, seed=2, eta=lambda t: 0.2)

    def sampler(r, t):
        s = (targets[:, None, None, :]
             + 0.05 * r.standard_normal((N, T, 2, P))).astype(np.float32)
        return ((torch.as_tensor(s),) if pkg == "port"
                else (jnp.asarray(s),))

    if pkg == "port":
        return FederatedServer(
            topology.make_spec(family, **spec).build(), quad_loss,
            {"x": torch.zeros(P)}, sampler, ServerConfig(**cfg),
            execution=ExecutionConfig(backend=backend, stream=stream),
            device="cpu")
    return JServer(jtopology.make_spec(family, **spec).build(),
                   jquad_loss, {"x": jnp.zeros(P)}, sampler,
                   JServerConfig(**cfg),
                   execution=JExec(backend=backend, stream=stream))


@pytest.mark.parametrize("backend", ["einsum", "fused"])
@pytest.mark.parametrize("controller", ["threshold:tau=2", "static"])
def test_execute_controlled_equals_the_reference(controller, backend):
    """The closed loop on the stream runtime under faults: the same
    realized plan, telemetry (control and stream) and closures; params
    allclose.  The realized plan replays the run bitwise through a
    fault-free StreamEngine with the same closure policy."""
    stream_kw = dict(buffer=6, deadline=1.0, staleness="poly",
                     fault_seed=5)
    fault_kw = dict(failures="markov",
                    failure_params={"p_fail": 0.2, "p_recover": 0.5},
                    latency="exponential", latency_params={"mean": 0.8})
    S, JS = _streams(stream_kw, fault_kw)
    srv, jsrv = _server("port", S, backend), _server("ref", JS, backend)
    h = srv.run(controller=controller)
    jh = jsrv.run(controller=controller)
    assert _digest(h) == _digest(jh)
    assert srv.engine.last_closures == jsrv.engine.last_closures
    assert srv.last_plan.to_json() == jsrv.last_plan.to_json()
    assert any(r.stream for r in h.records)
    _close(srv.params, jsrv.params)
    # replay: the realized plan through a fault-free engine
    replay = _server("port", dataclasses.replace(S, faults=None), backend)
    h2 = replay.run(plan=srv.last_plan)
    assert torch.equal(replay.params["x"], srv.params["x"])
    assert [row[:8] for row in _digest(h2)[0]] == \
        [row[:8] for row in _digest(h)[0]]


def test_execute_controlled_refusals():
    S = StreamConfig()
    with pytest.raises(ValueError, match="needs_deltas"):
        _server("port", S, "einsum", family="learned", n=N, c=C,
                k=3).run(controller="similarity")
    with pytest.raises(ValueError, match="client_optim"):
        _server("port", StreamConfig(client_optim="sgd"),
                "einsum").run(controller="threshold")


# ---------------------------------------------------------------------------
# the port's own pins
# ---------------------------------------------------------------------------

def _eval(prm):
    return {"l2": float(torch.sum(prm["x"] ** 2))}


@pytest.mark.parametrize("backend", ["einsum", "fused", "aggregate"])
@pytest.mark.parametrize("stream", [StreamConfig(), StreamConfig(buffer=N)],
                         ids=["pristine", "full_buffer"])
def test_pristine_stream_equals_local_engine_bitwise(backend, stream):
    plan, params, batches = _problem()[:3]
    p1, h1 = LocalEngine(quad_loss, ExecutionConfig(backend=backend),
                         device="cpu").execute(plan, params, batches,
                                               eval_fn=_eval)
    p2, h2 = make_engine(ExecutionConfig(backend=backend, stream=stream),
                         quad_loss, device="cpu").execute(
        plan, params, batches, eval_fn=_eval)
    assert torch.equal(p1["x"], p2["x"])
    assert [r.metrics for r in h1.records] == [r.metrics for r in h2.records]
    assert _digest(h1) == _digest(h2)


def test_dropout_plan_stream_equals_local_engine_bitwise():
    plan, params, batches = _problem()[:3]
    plan = plan.with_dropout(0.3, np.random.default_rng(5))
    p1, h1 = LocalEngine(quad_loss, ExecutionConfig(), device="cpu") \
        .execute(plan, params, batches, eval_fn=_eval)
    p2, h2 = make_engine(ExecutionConfig(stream=StreamConfig()), quad_loss,
                         device="cpu").execute(plan, params, batches,
                                               eval_fn=_eval)
    assert torch.equal(p1["x"], p2["x"])
    assert _digest(h1) == _digest(h2)


@pytest.mark.parametrize("backend", ["einsum", "aggregate"])
def test_zero_latency_trace_equals_local_engine_with_faults(backend):
    plan, params, batches = _problem()[:3]
    spec = FaultSpec(failures="markov",
                     failure_params={"p_fail": 0.3, "p_recover": 0.5})
    eng = make_engine(ExecutionConfig(
        backend=backend, stream=StreamConfig(faults=spec, fault_seed=11)),
        quad_loss, device="cpu")
    p2, h2 = eng.execute(plan, params, batches, eval_fn=_eval)
    trace = sample_trace(spec, n=plan.n_clients, K=plan.n_rounds, seed=11)
    p1, h1 = LocalEngine(quad_loss, ExecutionConfig(backend=backend),
                         device="cpu").execute(plan.with_faults(trace),
                                               params, batches,
                                               eval_fn=_eval)
    assert torch.equal(p1["x"], p2["x"])
    assert [row[:7] for row in _digest(h1)[0]] == \
        [row[:7] for row in _digest(h2)[0]]
    assert eng.last_realized_plan.allclose(plan.with_faults(trace))


@pytest.mark.parametrize("backend", ["einsum", "aggregate"])
def test_fault_trajectory_replays_bitwise_from_json(backend):
    plan, params, batches = _problem()[:3]
    spec = FaultSpec(failures="iid", failure_params={"rate": 0.25},
                     latency="uniform", latency_params={"lo": 0.0,
                                                        "hi": 1.4},
                     duplicate_rate=0.2)
    policy = StreamConfig(buffer=5, deadline=1.0, staleness="poly")

    def run(s, the_plan=plan):
        eng = make_engine(ExecutionConfig(backend=backend, stream=s),
                          quad_loss, device="cpu")
        return (*eng.execute(the_plan, params, batches), eng)

    p1, h1, e1 = run(dataclasses.replace(policy, faults=spec,
                                         fault_seed=5))
    p2, h2, e2 = run(dataclasses.replace(
        policy, faults=FaultSpec.from_json(spec.to_json()), fault_seed=5))
    assert torch.equal(p1["x"], p2["x"]) and _digest(h1) == _digest(h2)
    assert e1.last_trace.allclose(e2.last_trace)
    assert e1.last_closures == e2.last_closures
    # the realized plan, through JSON, with no fault spec: same params
    # (the duplicate flags live in the trace, so d2s may differ)
    realized = RoundPlan.from_json(e1.last_realized_plan.to_json())
    p3, h3, _ = run(policy, realized)
    assert torch.equal(p1["x"], p3["x"])
    assert [(r.t, r.m, r.m_actual, r.d2d) for r in h1.records] == \
        [(r.t, r.m, r.m_actual, r.d2d) for r in h3.records]
    # and with the trace injected, History too
    eng = make_engine(ExecutionConfig(backend=backend, stream=policy),
                      quad_loss, device="cpu")
    p4, h4 = eng.execute(realized, params, batches, trace=e1.last_trace)
    assert torch.equal(p1["x"], p4["x"]) and _digest(h1) == _digest(h4)


def test_unit_staleness_weight_is_bitwise_none():
    rng = np.random.default_rng(0)
    n = 10
    A = torch.as_tensor(rng.random((n, n)), dtype=torch.float32)
    tau = torch.as_tensor(rng.random(n) < 0.6, dtype=torch.float32)
    act = torch.as_tensor(rng.random(n) < 0.8, dtype=torch.float32)
    m = torch.tensor(4.0)
    base = combine_weights(A, tau, m, act)
    for w in (torch.tensor(1.0), torch.ones(n), 1.0):
        assert torch.equal(combine_weights(A, tau, m, act, w), base)
    half = combine_weights(A, tau, m, act, torch.tensor(0.5))
    torch.testing.assert_close(half, 0.5 * base, rtol=1e-6, atol=0)


def test_stale_path_at_weight_one_keeps_the_raw_divisor():
    plan, params, batches = _problem(K=4)[:3]
    spec = FaultSpec(latency="fixed", latency_params={"value": 1.0})
    _, h = make_engine(ExecutionConfig(
        backend="aggregate", stream=StreamConfig(deadline=0.5, faults=spec)),
        quad_loss, device="cpu").execute(plan, params, batches)
    assert any(r.stream and r.stream.get("late") for r in h.records)
    assert all(not r.stream or "m_weighted" not in r.stream
               for r in h.records)


def test_snapshots_stay_unchanged(monkeypatch):
    """Stale cohorts train against the params their round dispatched
    with: nothing on the path may write a param tensor in place."""
    books = []

    @dataclasses.dataclass
    class Watched(tstream._Cohort):
        def __post_init__(self):
            books.append((self.snapshot,
                          {k: v.clone() for k, v in self.snapshot.items()}))

    monkeypatch.setattr(tstream, "_Cohort", Watched)
    plan, params, batches = _problem()[:3]
    for backend in ("einsum", "aggregate"):
        books.clear()
        spec = FaultSpec(latency="exponential", latency_params={"mean": 1.2})
        _, h = make_engine(ExecutionConfig(
            backend=backend, stream=StreamConfig(
                buffer=4, deadline=2.0, staleness="poly", faults=spec,
                fault_seed=9)), quad_loss, device="cpu").execute(
            plan, params, batches)
        assert any(r.stream and r.stream.get("late") for r in h.records)
        assert len(books) == plan.n_rounds
        for snap, copy in books:
            assert all(torch.equal(snap[k], copy[k]) for k in copy)


def test_apply_aggregate_row_is_out_of_place():
    params = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4)}
    keep = {k: v.clone() for k, v in params.items()}
    spec = packing.pack_spec({k: v[None] for k, v in params.items()})
    rows = tuple(torch.full((spec.groups[0].padded,), 0.5)
                 for _ in spec.groups)
    out = packing.apply_aggregate_row(params, rows, spec)
    for k in params:
        assert torch.equal(params[k], keep[k])
        assert out[k].data_ptr() != params[k].data_ptr()
        assert torch.equal(out[k], keep[k] + 0.5)


def test_stream_config_validation():
    for bad in (dict(buffer=0), dict(deadline=0.0), dict(staleness="nope"),
                dict(max_staleness=-1), dict(client_optim="sgd,nadam")):
        with pytest.raises(ValueError):
            StreamConfig(**bad)


def test_engine_construction_guards():
    with pytest.raises(ValueError, match="stream"):
        StreamEngine(quad_loss, ExecutionConfig(), device="cpu")
    with pytest.raises(ValueError, match="synchronous"):
        LocalEngine(quad_loss, ExecutionConfig(stream=StreamConfig()),
                    device="cpu")
    eng = make_engine(ExecutionConfig(stream=StreamConfig()), quad_loss,
                      device="cpu")
    assert isinstance(eng, StreamEngine)
    assert eng.device == torch.device("cpu")
    plan, params, batches = _problem(K=2)[:3]
    with pytest.raises(ValueError, match="quantized"):
        eng.execute(plan.with_quant(packing.QuantSpec()), params, batches)
    with pytest.raises(ValueError, match="faults must be None"):
        make_engine(ExecutionConfig(stream=StreamConfig(faults=FaultSpec(
            duplicate_rate=0.5))), quad_loss, device="cpu").execute(
            plan, params, batches,
            trace=sample_trace(FaultSpec(), n=N, K=2, seed=0))


def test_server_runs_the_stream_engine():
    spec = FaultSpec(failures="iid", failure_params={"rate": 0.2},
                     latency="exponential")
    srv = _server("port", StreamConfig(buffer=6, deadline=1.5,
                                       staleness="poly", faults=spec),
                  "fused")
    hist = srv.run(eval_fn=_eval)
    assert len(hist.records) == 5
    assert isinstance(srv.engine, StreamEngine)
    assert srv.effective_backend == "aggregate"
    assert all(math.isfinite(r.metrics["l2"]) for r in hist.records)


def test_stream_cli_selfcheck_and_replay(tmp_path, capsys):
    assert stream_cli.main(["--selfcheck", "--device", "cpu",
                            "--backend", "fused"]) == 0
    assert "all OK" in capsys.readouterr().out
    args = ["--device", "cpu", "--model", "logreg", "--rounds", "3",
            "--n", "10", "--clusters", "2", "--k-min", "2", "--k-max", "3",
            "--samples", "300", "--T", "2", "--batch", "4", "--quiet",
            "--buffer", "6", "--deadline", "1.0", "--staleness", "poly"]
    plan = tmp_path / "realized.json"
    out1, out2 = tmp_path / "a.json", tmp_path / "b.json"
    assert stream_cli.main(args + [
        "--faults", "markov:p_fail=0.2,latency=exponential,mean=0.8",
        "--plan-out", str(plan), "--out", str(out1)]) == 0
    assert stream_cli.main(args + ["--plan", str(plan),
                                   "--out", str(out2)]) == 0
    import json
    r1, r2 = (json.loads(p.read_text()) for p in (out1, out2))
    assert [(r["t"], r["m"], r["d2d"]) for r in r1["rounds"]] == \
        [(r["t"], r["m"], r["d2d"]) for r in r2["rounds"]]
    assert [r["test_loss"] for r in r1["rounds"]] == \
        [r["test_loss"] for r in r2["rounds"]]
    assert any("stream" in r for r in r1["rounds"])


def test_entry_points_run_on_cuda_unless_told_otherwise(monkeypatch):
    from repro_torch.launch import ingest as ingest_cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_engine(ExecutionConfig(stream=StreamConfig()), quad_loss)
    for cli in (stream_cli, ingest_cli):
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(["--rounds", "1"])
