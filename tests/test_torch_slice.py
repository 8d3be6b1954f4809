"""Algorithm 1 end to end: the PyTorch port's ``FederatedServer`` against
the JAX reference's, on the CPU at a small size (n = 6 clients in c = 2
clusters, 8x8 images, T = 2, 2-3 rounds).

Both servers get the same seed, the same numpy data and the same weights
(carried into the port with ``repro_torch.models.convert``).  The History
bookkeeping -- planned and actual sample sizes, D2S/D2D counts, the psi
bound, the ledger -- is host-side numpy and must be exactly equal; params
and metrics are ``allclose`` with ``rtol=1e-4, atol=1e-5``: XLA and torch
reduce the convolutions, matmuls and mixing sums in different orders,
and a few rounds of SGD carry those fp32 differences forward.

Then the port's own bitwise pins: scanned == sequential, all-ones
``active`` == ``None``, and a fully dropped round carries the params.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import topology as jtopology
from repro.core.server import FederatedServer as JServer
from repro.core.server import ServerConfig as JServerConfig
from repro.data import FederatedBatcher as JBatcher
from repro.fl.engine import ExecutionConfig as JExec
from repro.models import cnn as jcnn
from repro_torch import topology
from repro_torch.core.pytree import tree_flatten
from repro_torch.core.rounds import make_round_fn
from repro_torch.core.server import FederatedServer, ServerConfig
from repro_torch.data import (FederatedBatcher, label_sorted_partition,
                              make_classification)
from repro_torch.fl.engine import ExecutionConfig
from repro_torch.fl.plan import RoundPlan
from repro_torch.models import cnn
from repro_torch.models.convert import params_from_numpy, params_to_numpy

jax.config.update("jax_enable_x64", False)

N, C, T, B, HW = 6, 2, 2, 4, 8
TOL = dict(rtol=1e-4, atol=1e-5)
MODELS = {"cnn": (jcnn.init_cnn, jcnn.cnn_apply, cnn.cnn_apply),
          "logreg": (jcnn.init_logreg, jcnn.logreg_apply, cnn.logreg_apply)}


def _setup(model, rounds):
    ds = make_classification(n_samples=240, image_hw=HW, seed=0)
    test = make_classification(n_samples=60, image_hw=HW, seed=1)
    parts = label_sorted_partition(ds, N, rng=np.random.default_rng(0))
    init, japply, tapply = MODELS[model]
    kw = dict(image_hw=HW) if model == "cnn" else dict(d_in=HW * HW)
    jparams = init(0, **kw)
    cfg = dict(T=T, t_max=rounds, phi_max=0.3, seed=4,
               eta=lambda t: 0.05 * (0.8 ** t))
    spec = dict(n=N, c=C, k_range=(2, 3), p_fail=0.1)
    return ds, test, parts, jparams, japply, tapply, cfg, spec


def _run_jax(model, backend, record_mixed, scan, rounds):
    ds, test, parts, jparams, japply, _, cfg, spec = _setup(model, rounds)
    loss = partial(jcnn.l2_regularized_loss, japply)
    xs, ys = jnp.asarray(test.x), jnp.asarray(test.y)
    server = JServer(jtopology.make_spec("k_regular", **spec).build(), loss,
                     jparams, JBatcher(ds, parts, T=T, batch_size=B),
                     JServerConfig(**cfg),
                     execution=JExec(backend=backend, scan=scan,
                                     record_mixed=record_mixed))
    hist = server.run(eval_fn=lambda p: {"loss": float(loss(p, (xs, ys)))})
    return server, hist


def _run_torch(model, backend, record_mixed, scan, rounds, plan=None,
               keep=None):
    ds, test, parts, jparams, _, tapply, cfg, spec = _setup(model, rounds)
    loss = partial(cnn.l2_regularized_loss, tapply)
    xs = torch.as_tensor(test.x)
    ys = torch.as_tensor(test.y).long()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")

    def eval_fn(p):
        if keep is not None:
            keep.append([x.clone() for x in tree_flatten(p)[0]])
        with torch.no_grad():
            return {"loss": float(loss(p, (xs, ys)))}

    server = FederatedServer(topology.make_spec("k_regular", **spec).build(),
                             loss, params,
                             FederatedBatcher(ds, parts, T=T, batch_size=B),
                             ServerConfig(**cfg),
                             execution=ExecutionConfig(
                                 backend=backend, scan=scan,
                                 record_mixed=record_mixed),
                             device="cpu")
    return server, server.run(eval_fn=eval_fn, plan=plan)


def _bookkeeping(hist):
    return ([(r.t, r.m, r.m_actual, r.d2s, r.d2d, r.psi_bound, r.eta)
             for r in hist.records],
            hist.ledger.total_cost, hist.ledger.total_d2s,
            hist.ledger.total_d2d)


@pytest.mark.parametrize("model,backend,record_mixed,scan", [
    ("cnn", "einsum", False, False),
    ("cnn", "fused", False, True),           # -> aggregate kernel
    ("cnn", "fused", True, False),           # -> mix_aggregate kernel
    ("cnn", "pallas", True, False),          # -> mix kernel
    ("logreg", "pallas", True, True),        # -> mix kernel
    ("logreg", "fused", True, True),
])
def test_server_matches_reference(model, backend, record_mixed, scan):
    js, jh = _run_jax(model, backend, record_mixed, scan, rounds=2)
    ts, th = _run_torch(model, backend, record_mixed, scan, rounds=2)
    assert ts.effective_backend == js.effective_backend
    assert _bookkeeping(th) == _bookkeeping(jh)
    assert ts.last_plan.to_json() == js.last_plan.to_json()
    got = params_to_numpy(ts.params)
    want = jax.tree.map(np.asarray, js.params)
    for g, w in zip(tree_flatten(got)[0], jax.tree.leaves(want)):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(th.series("loss"), jh.series("loss"), **TOL)


@pytest.mark.parametrize("backend,record_mixed", [
    ("einsum", False), ("fused", False), ("fused", True), ("pallas", True)])
def test_port_scanned_equals_sequential_bitwise(backend, record_mixed):
    seq, hs = _run_torch("logreg", backend, record_mixed, False, rounds=3)
    scn, hc = _run_torch("logreg", backend, record_mixed, True, rounds=3)
    assert _bookkeeping(hs) == _bookkeeping(hc)
    for a, b in zip(tree_flatten(seq.params)[0], tree_flatten(scn.params)[0]):
        assert torch.equal(a, b)
    assert hs.series("loss").tolist() == hc.series("loss").tolist()


@pytest.mark.parametrize("backend", ["einsum", "pallas", "fused",
                                     "aggregate"])
def test_port_all_ones_active_is_bitwise_none(backend):
    rng = np.random.default_rng(0)
    params = cnn.init_logreg(0, d_in=HW * HW)
    loss = partial(cnn.l2_regularized_loss, cnn.logreg_apply)
    batches = (torch.as_tensor(rng.standard_normal((N, T, B, HW, HW, 1)),
                               dtype=torch.float32),
               torch.as_tensor(rng.integers(0, 10, (N, T, B))))
    A = torch.as_tensor(rng.random((N, N)), dtype=torch.float32)
    tau = torch.tensor([1., 0., 1., 1., 0., 1.])
    m, eta = tau.sum(), torch.tensor(0.1)
    fn = make_round_fn(loss, backend)
    p0, mix0 = fn(params, batches, A, tau, m, eta)
    p1, mix1 = fn(params, batches, A, tau, m, eta, torch.ones(N))
    for a, b in zip(tree_flatten(p0)[0], tree_flatten(p1)[0]):
        assert torch.equal(a, b)
    if mix0 is not None:
        for a, b in zip(tree_flatten(mix0)[0], tree_flatten(mix1)[0]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("backend,record_mixed,scan", [
    ("einsum", False, False), ("fused", False, True), ("fused", True, False),
    ("pallas", True, True)])
def test_port_dropped_round_carries_params(backend, record_mixed, scan):
    ds, _, parts, _, _, _, cfg, spec = _setup("logreg", 3)
    plan = RoundPlan.connectivity_aware(
        topology.make_spec("k_regular", **spec).build(), ServerConfig(**cfg))
    mask = np.ones_like(plan.active_t)
    mask[1] = 0.0                       # every client drops in round 1
    keep = []
    _, hist = _run_torch("logreg", backend, record_mixed, scan, rounds=3,
                         plan=plan.with_active(mask), keep=keep)
    assert hist.records[1].m_actual == 0 and hist.records[1].d2s == 0
    for a, b in zip(keep[0], keep[1]):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(keep[1], keep[2]))
