"""The closed loop of the port (``repro_torch.control``,
``RoundPlan.controlled``, ``LocalEngine.execute_controlled``,
``FederatedServer.run(controller=)``, ``launch.train --controller``)
against the JAX reference on the CPU, at a small size (n = 12 clients in
c = 2 clusters, a quadratic or logreg loss, 3-4 rounds).

Planning and control are numpy in both packages and draw
``default_rng(seed)`` in the same order, so the realized host columns --
``A_t``, ``tau_t``, ``m_t``, ``eta_t``, ``d2s``, ``d2d``, ``psi_bound``
-- and the controllers' telemetry must be *equal*, dense and sparse.
Params of a controlled run are ``allclose`` to the reference's with
``rtol=1e-4, atol=1e-5`` (as ``test_torch_slice.py``: XLA and torch
reduce in different orders, and rounds of SGD carry fp32 differences
forward).  Then the port's twins of the reference's own pins
(``tests/test_control.py``): the static controller equals the
precomputed plan on every kernel backend, adaptive runs replay bitwise,
static regenerates from spec, offline planning refuses delta feedback,
the server's and the CLI's refusals, and ``_fold_active`` ==
``with_active``.
"""

import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import control as jcontrol
from repro import topology as jtopology
from repro.core.server import FederatedServer as JServer
from repro.core.server import ServerConfig as JServerConfig
from repro.fl.engine import ExecutionConfig as JExec
from repro.fl.plan import RoundPlan as JRoundPlan
from repro.models import cnn as jcnn
from repro_torch import control, topology
from repro_torch.control import ControlLoop, ControllerSpec, Decision
from repro_torch.core.server import FederatedServer, ServerConfig
from repro_torch.data import (FederatedBatcher, label_sorted_partition,
                              make_classification)
from repro_torch.fl.engine import ExecutionConfig, LocalEngine
from repro_torch.fl.packing import QuantSpec
from repro_torch.fl.plan import RoundPlan
from repro_torch.launch import train
from repro_torch.models import cnn

jax.config.update("jax_enable_x64", False)

N, C, P = 12, 2, 4
TOL = dict(rtol=1e-4, atol=1e-5)
SPEC = dict(n=N, c=C, k_range=(4, 6), p_fail=0.1)
ADAPTIVE = ["threshold", "threshold:phi_max=0.15,mu=0.1,beta=4.0",
            "threshold:tau=2", "threshold:scheme=sampled"]


def quad_loss(params, batch):
    x = params["x"]
    b, = batch
    return 0.5 * torch.sum((x - b.mean(dim=0)) ** 2)


def jquad_loss(params, batch):
    x = params["x"]
    b, = batch
    return 0.5 * jnp.sum((x - b.mean(axis=0)) ** 2)


def _cfg(cls=ServerConfig, t_max=4, phi_max=0.3, **kw):
    return cls(T=3, t_max=t_max, phi_max=phi_max, seed=3,
               eta=lambda t: 0.2 / (1 + 0.3 * t), **kw)


def _nets(family="k_regular", **params):
    params = params or dict(SPEC)
    return (topology.make_spec(family, **params).build(),
            jtopology.make_spec(family, **params).build())


def _sampler(n, p, T=3, B=2, jax_arrays=False):
    targets = np.random.default_rng(11).standard_normal((n, p)) \
        .astype(np.float32)

    def sampler(r, t):
        samp = (targets[:, None, None, :]
                + 0.05 * r.standard_normal((n, T, B, p))).astype(np.float32)
        return ((jnp.asarray(samp),) if jax_arrays
                else (torch.as_tensor(samp),))

    return sampler


def _server(net, cfg, execution=None, algorithm="semidec"):
    return FederatedServer(net, quad_loss, {"x": torch.zeros(P)},
                           _sampler(net.n, P), cfg, algorithm=algorithm,
                           execution=execution, device="cpu")


def _gap(prm):
    return {"gap": float(torch.sum(prm["x"] ** 2))}


def _rec_tuple(rec):
    """RoundRecord identity minus the live-only ``control`` telemetry
    (None on replays by design)."""
    return (rec.t, rec.m, rec.m_actual, rec.psi_bound, rec.d2s, rec.d2d,
            rec.eta, rec.metrics)


def _assert_same_run(hist_a, hist_b, params_a, params_b):
    assert torch.equal(params_a["x"], params_b["x"])
    assert len(hist_a.records) == len(hist_b.records)
    for a, b in zip(hist_a.records, hist_b.records):
        assert _rec_tuple(a) == _rec_tuple(b)


# ---------------------------------------------------------------------------
# host columns and telemetry: equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("controller", ["static"] + ADAPTIVE)
def test_controlled_plan_equals_the_reference(controller, sparse):
    net, jnet = _nets()
    plan = RoundPlan.controlled(net, _cfg(), controller, sparse=sparse)
    jplan = JRoundPlan.controlled(jnet, _cfg(JServerConfig), controller,
                                  sparse=sparse)
    assert plan.is_sparse == sparse
    # the JSON carries every column: A_t, tau_t, m_t, eta_t, active_t,
    # m_planned/m_actual, d2s, d2d, psi_bound, topology and seed
    assert plan.to_json() == jplan.to_json()


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("controller", ["static"] + ADAPTIVE)
def test_control_telemetry_equals_the_reference(controller, sparse):
    net, jnet = _nets()
    loop = ControlLoop(net, _cfg(), controller, sparse=sparse)
    jloop = jcontrol.ControlLoop(jnet, _cfg(JServerConfig), controller,
                                 sparse=sparse)
    for _ in range(4):
        (row, tel), (jrow, jtel) = loop.next_row(), jloop.next_row()
        assert tel == jtel
        assert (row.m, row.m_planned, row.d2s, row.d2d, row.psi_bound,
                row.eta) == (jrow.m, jrow.m_planned, jrow.d2s, jrow.d2d,
                             jrow.psi_bound, jrow.eta)


def test_similarity_fed_the_same_deltas_realizes_the_same_graphs():
    params = dict(n=N, c=C, k=3)
    net, jnet = _nets("learned", **params)
    loop = ControlLoop(net, _cfg(), "similarity:ema=0.5,graph_every=1")
    jloop = jcontrol.ControlLoop(jnet, _cfg(JServerConfig),
                                 "similarity:ema=0.5,graph_every=1")
    assert loop.needs_deltas and jloop.needs_deltas
    rng = np.random.default_rng(2)
    for t in range(3):
        (row, tel), (jrow, jtel) = loop.next_row(), jloop.next_row()
        np.testing.assert_array_equal(row.A, np.asarray(jrow.A))
        np.testing.assert_array_equal(row.tau, jrow.tau)
        assert tel == jtel
        deltas = rng.standard_normal((N, 7)).astype(np.float32)
        loop.feed(None, deltas)
        jloop.feed(None, deltas)
        np.testing.assert_array_equal(loop.controller._S,
                                      jloop.controller._S)
    assert loop.emit_plan().to_json() == jloop.emit_plan().to_json()


# ---------------------------------------------------------------------------
# params: a controlled run against the reference's
# ---------------------------------------------------------------------------

def _jserver(jnet, cfg, backend="einsum", record_mixed=False):
    return JServer(jnet, jquad_loss, {"x": jnp.zeros(P)},
                   _sampler(jnet.n, P, jax_arrays=True), cfg,
                   execution=JExec(backend=backend,
                                   record_mixed=record_mixed))


@pytest.mark.parametrize("backend,record_mixed", [
    ("einsum", False), ("fused", True), ("sparse", False)])
@pytest.mark.parametrize("controller", ["static", "threshold:tau=2",
                                        "threshold:scheme=sampled"])
def test_controlled_run_matches_the_reference(controller, backend,
                                              record_mixed):
    net, jnet = _nets()
    s = _server(net, _cfg(), ExecutionConfig(backend=backend,
                                             record_mixed=record_mixed))
    js = _jserver(jnet, _cfg(JServerConfig), backend, record_mixed)
    h = s.run(controller=controller)
    jh = js.run(controller=controller)
    assert s.last_plan.to_json() == js.last_plan.to_json()
    for a, b in zip(h.records, jh.records):
        assert (a.t, a.m, a.m_actual, a.psi_bound, a.d2s, a.d2d, a.eta,
                a.control) == (b.t, b.m, b.m_actual, b.psi_bound, b.d2s,
                               b.d2d, b.eta, b.control)
    np.testing.assert_allclose(s.params["x"].numpy(),
                               np.asarray(js.params["x"]), **TOL)


def test_controlled_logreg_run_matches_the_reference():
    hw, n = 8, 6
    ds = make_classification(n_samples=240, image_hw=hw, seed=0)
    parts = label_sorted_partition(ds, n, rng=np.random.default_rng(0))
    from repro.data import FederatedBatcher as JBatcher
    from repro_torch.models.convert import params_from_numpy
    jparams = jcnn.init_logreg(0, d_in=hw * hw)
    spec = dict(n=n, c=2, k_range=(2, 3), p_fail=0.1)
    cfg = dict(T=2, t_max=3, phi_max=0.3, seed=4,
               eta=lambda t: 0.05 * (0.8 ** t))
    js = JServer(jtopology.make_spec("k_regular", **spec).build(),
                 partial(jcnn.l2_regularized_loss, jcnn.logreg_apply),
                 jparams, JBatcher(ds, parts, T=2, batch_size=4),
                 JServerConfig(**cfg), execution=JExec(backend="fused"))
    s = FederatedServer(
        topology.make_spec("k_regular", **spec).build(),
        partial(cnn.l2_regularized_loss, cnn.logreg_apply),
        params_from_numpy(jax.tree.map(np.asarray, jparams)),
        FederatedBatcher(ds, parts, T=2, batch_size=4), ServerConfig(**cfg),
        execution=ExecutionConfig(backend="fused"), device="cpu")
    jh = js.run(controller="threshold")
    h = s.run(controller="threshold")
    assert [r.control for r in h.records] == [r.control for r in jh.records]
    for k in ("w", "b"):
        np.testing.assert_allclose(s.params[k].numpy(),
                                   np.asarray(js.params[k]), **TOL)


# ---------------------------------------------------------------------------
# the port's pins (twins of the reference's)
# ---------------------------------------------------------------------------

def test_registry_specs_and_decisions():
    assert set(control.controllers()) >= {"static", "threshold",
                                          "similarity"}
    assert control.controllers() == jcontrol.controllers()
    spec = control.make_spec("similarity", ema=0.7, graph_every=2)
    assert ControllerSpec.from_dict(spec.as_dict()) == spec
    assert control.from_json(spec.to_json()).spec == spec
    assert control.parse_spec("similarity:ema=0.7,graph_every=2") == spec
    assert spec.to_json() == jcontrol.make_spec(
        "similarity", ema=0.7, graph_every=2).to_json()
    with pytest.raises(ValueError, match="unknown parameter"):
        control.make_spec("threshold", nope=1)
    with pytest.raises(ValueError, match="unknown controller family"):
        control.make_spec("no_such_policy")
    with pytest.raises(ValueError, match="malformed controller option"):
        control.parse_spec("threshold:phi_max")
    with pytest.raises(ValueError, match="m must be >= 1"):
        Decision(m=0)
    with pytest.raises(ValueError, match="scheme"):
        Decision(m=3, scheme="broadcast")


@pytest.mark.parametrize("execution", [
    ExecutionConfig(backend="einsum"),
    ExecutionConfig(backend="fused", record_mixed=True),
    ExecutionConfig(backend="aggregate"),
    ExecutionConfig(backend="sparse"),
], ids=["einsum", "fused", "aggregate", "sparse"])
def test_static_controller_matches_precomputed_plan(execution):
    net, _ = _nets()
    cfg = _cfg()
    s_plan = _server(net, cfg, execution)
    sparse = s_plan.effective_backend in ("sparse", "sparse_aggregate")
    plan = RoundPlan.connectivity_aware(net, cfg, sparse=sparse)
    h_plan = s_plan.run(eval_fn=_gap, plan=plan)
    s_ctl = _server(net, cfg, execution)
    h_ctl = s_ctl.run(eval_fn=_gap, controller="static")
    _assert_same_run(h_plan, h_ctl, s_plan.params, s_ctl.params)
    # static never asks for realized phi: zero per-round control cost
    assert all(rec.control is None for rec in h_ctl.records)


def test_static_realized_plan_regenerates_from_spec():
    net, _ = _nets()
    plan = RoundPlan.controlled(net, _cfg(), "static")
    assert plan.seed is not None
    again = plan.regenerate()
    assert again.to_json() == plan.to_json()


@pytest.mark.parametrize("backend", ["einsum", "sparse"])
@pytest.mark.parametrize("controller", ADAPTIVE)
def test_adaptive_run_replays_bitwise(controller, backend):
    net, _ = _nets()
    cfg = _cfg()
    ex = ExecutionConfig(backend=backend, record_mixed=backend == "sparse")
    s_live = _server(net, cfg, ex)
    h_live = s_live.run(eval_fn=_gap, controller=controller)
    realized = s_live.last_plan
    assert realized.n_rounds == cfg.t_max
    assert realized.is_sparse == (backend == "sparse")
    s_replay = _server(net, cfg, ex)
    h_replay = s_replay.run(eval_fn=_gap, plan=realized)
    _assert_same_run(h_live, h_replay, s_live.params, s_replay.params)
    # live rounds carry realized-connectivity telemetry, replays don't
    assert all(rec.control is not None for rec in h_live.records)
    assert all(rec.control is None for rec in h_replay.records)


def test_threshold_plan_regenerable_but_gossip_not():
    net, _ = _nets()
    assert RoundPlan.controlled(net, _cfg(), "threshold").seed is not None
    for ctl in ("threshold:tau=2", "threshold:scheme=sampled"):
        assert RoundPlan.controlled(net, _cfg(), ctl).seed is None


def test_offline_planning_rejects_delta_feedback():
    net, _ = _nets("learned", n=N, c=C)
    with pytest.raises(ValueError, match="cannot plan offline"):
        RoundPlan.controlled(net, _cfg(), "similarity")


def test_similarity_requires_learned_topology():
    net, _ = _nets()
    with pytest.raises(ValueError, match="set_similarity"):
        ControlLoop(net, _cfg(), "similarity")


def test_similarity_run_replays_bitwise_and_is_not_regenerable():
    spec = topology.make_spec("learned", n=N, c=C, k=3)
    cfg = _cfg()
    s_live = _server(spec.build(), cfg)
    h_live = s_live.run(controller="similarity:ema=0.5,graph_every=1")
    realized = s_live.last_plan
    assert realized.seed is None   # graph depends on training data
    s_replay = _server(spec.build(), cfg)
    h_replay = s_replay.run(plan=realized)
    _assert_same_run(h_live, h_replay, s_live.params, s_replay.params)
    # the learned graph actually moved: later rounds differ from round 0
    assert not np.array_equal(np.asarray(realized[0].A),
                              np.asarray(realized[-1].A))


def test_server_refusals():
    net, _ = _nets()
    cfg = _cfg()
    plan = RoundPlan.connectivity_aware(net, cfg)
    with pytest.raises(ValueError, match="not both"):
        _server(net, cfg).run(plan=plan, controller="static")
    fedavg = _server(net, _cfg(m_fixed=6), algorithm="fedavg")
    with pytest.raises(ValueError, match="semidec"):
        fedavg.run(controller="static")
    server = _server(net, cfg)
    server.engine = types.SimpleNamespace(backend="einsum")
    with pytest.raises(ValueError, match="execute_controlled"):
        server.run(controller="static")


@pytest.mark.parametrize("cfg,sparse,match", [
    (ExecutionConfig(scan=True), False, "per-round"),
    (ExecutionConfig(backend="fused", quant=QuantSpec()), False,
     "quantized"),
    (ExecutionConfig(backend="sparse"), False, "sparsity"),
    (ExecutionConfig(backend="einsum"), True, "sparsity")])
def test_execute_controlled_refusals(cfg, sparse, match):
    net, _ = _nets()
    engine = LocalEngine(quad_loss, cfg, device="cpu")
    loop = ControlLoop(net, _cfg(), "static", sparse=sparse)
    with pytest.raises(ValueError, match=match):
        engine.execute_controlled(loop, {"x": torch.zeros(P)}, [])


@pytest.mark.parametrize("sparse", [False, True])
def test_fold_active_matches_with_active(sparse):
    net, _ = _nets()
    cfg = _cfg()
    rng = np.random.default_rng(5)
    active = (rng.random((cfg.t_max, net.n)) > 0.25).astype(np.float32)
    loop_fold = ControlLoop(net, cfg, "static", sparse=sparse)
    loop_flat = ControlLoop(net, cfg, "static", sparse=sparse)
    for t in range(cfg.t_max):
        loop_fold.next_row(active=active[t])
        loop_flat.next_row()
    folded = loop_fold.emit_plan()
    masked = loop_flat.emit_plan().with_active(active)
    for t in range(cfg.t_max):
        a, b = folded[t], masked[t]
        assert (a.m, a.m_actual, a.d2s, a.d2d) == \
            (b.m, b.m_actual, b.d2s, b.d2d)
        np.testing.assert_array_equal(a.active, b.active)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

_CLI = ["--device", "cpu", "--model", "logreg", "--rounds", "2",
        "--samples", "400", "--quiet"]


def test_train_cli_controller_runs_and_replays(tmp_path, capsys):
    out = tmp_path / "realized.json"
    assert train.main(_CLI + ["--controller", "threshold:tau=2",
                              "--plan-out", str(out)]) == 0
    live = capsys.readouterr().out
    assert "realized trajectory saved" in live
    plan = RoundPlan.load(str(out))
    assert plan.n_rounds == 2 and plan.seed is None
    assert train.main(_CLI + ["--plan", str(out)]) == 0
    replay = capsys.readouterr().out
    cost = [ln for ln in live.splitlines() if "total comm cost" in ln]
    assert cost and cost == [ln for ln in replay.splitlines()
                             if "total comm cost" in ln]


@pytest.mark.parametrize("extra,match", [
    (["--plan", "x.json"], "cannot replay --plan"),
    (["--dropout", "0.2"], "mutually exclusive"),
    (["--quant", "int8"], "does not support --quant")])
def test_train_cli_controller_refusals(extra, match):
    with pytest.raises(SystemExit, match=match):
        train.main(_CLI + ["--controller", "static"] + extra)
