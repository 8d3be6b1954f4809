"""The sparse (ELL) slice of the PyTorch port against the JAX reference.

Kernels and ops: the same numpy inputs (made from a seed) go through the
reference's Pallas gather kernels and ``ops`` (interpret mode on the
CPU, as ``tests/test_sparse.py`` runs them) and through the port's,
whose wrappers take their plain versions for CPU tensors.  Tolerances:
fp32 outputs ``rtol=1e-5, atol=1e-6`` (XLA and torch sum in different
orders, a few fp32 ulps apart); bf16 mixed outputs ``rtol=atol=1e-2``
(both accumulate in fp32 and round once to bf16, and a few-ulp fp32
difference can flip that rounding by one bf16 ulp, 2^-8 relative).

Rounds and engine: the reference's parity sweep (every family x
{iid, markov, cluster} dropout x a fault trace, quadratic loss) through
the port's 'sparse' engine, against the reference's 'sparse' engine and
the port's own 'einsum' oracle on the dense plan.  History bookkeeping
is planning data and must be exactly equal; params ``atol=1e-5`` (fp32
reduction order).  Then a small-CNN slice against the reference server,
the port's bitwise pins (scanned == sequential, dense plan == the same
plan sparsified, resume slicing), the JSON v4 CSR encoding, the
n = 100,000 scale plan, and the CLI.
"""

import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import topology as jtopology
from repro.core.server import FederatedServer as JServer
from repro.core.server import ServerConfig as JServerConfig
from repro.core.sparse import SparseA as JSparseA
from repro.data import FederatedBatcher as JBatcher
from repro.fl import ExecutionConfig as JExec
from repro.fl import make_engine as jmake_engine
from repro.fl.plan import RoundPlan as JRoundPlan
from repro.kernels.mixing import ops as jops
from repro.kernels.mixing import sparse as jsparse
from repro.launch import train as jtrain
from repro.models import cnn as jcnn
from repro_torch import topology
from repro_torch.core.pytree import tree_flatten
from repro_torch.core.rounds import make_round_fn
from repro_torch.core.server import FederatedServer, ServerConfig
from repro_torch.core.sparse import SparseA, SparseAseq
from repro_torch.data import (FederatedBatcher, label_sorted_partition,
                              make_classification)
from repro_torch.fl.engine import ExecutionConfig, make_engine
from repro_torch.fl.plan import RoundPlan
from repro_torch.kernels.mixing import ops, ref, sparse
from repro_torch.launch import train
from repro_torch.models import cnn
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from test_torch_topology import _plans

jax.config.update("jax_enable_x64", False)

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
FAMILIES = topology.families()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _ell_inputs(n, p, seed, max_deg=4):
    """A random sparse nonnegative A (1..max_deg entries a row, as in the
    reference's tests), its ELL pair, a payload and the masks."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n), np.float32)
    for i in range(n):
        nbrs = rng.choice(n, size=rng.integers(1, max_deg + 1),
                          replace=False)
        A[i, nbrs] = rng.random(len(nbrs)).astype(np.float32) + 0.1
    idx, w = SparseA.from_dense(A).ell()
    jidx, jw = JSparseA.from_dense(A).ell()
    assert np.array_equal(idx, jidx) and np.array_equal(w, jw)
    X = rng.standard_normal((n, p)).astype(np.float32)
    tau = (rng.random(n) < 0.6).astype(np.float32)
    tau[0] = 1.0
    active = (rng.random(n) < 0.8).astype(np.float32)
    weights = rng.random(n).astype(np.float32)
    return A, idx, w, X, tau, active, weights


# ---------------------------------------------------------------------------
# kernel modules and ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_kernel_modules_match_pallas(dt):
    jdt, tdt = DTYPES[dt]
    n, p, chunk = 16, 256, 128            # Pallas-aligned shapes
    _, idx, w, X, _, _, wrow = _ell_inputs(n, p, seed=1)
    wrow_pad = np.zeros((8, n), np.float32)
    wrow_pad[0] = wrow
    tol = F32_TOL if dt == "f32" else BF16_TOL
    jX = jnp.asarray(X, jdt)
    tX = torch.from_numpy(X).to(tdt)
    tidx, tw = torch.from_numpy(idx), torch.from_numpy(w)

    got = sparse.sparse_mix_cuda(tidx, tw, tX)
    assert got.dtype == tdt
    _close(got, jsparse.sparse_mix_pallas(jnp.asarray(idx), jnp.asarray(w),
                                          jX, chunk=chunk, interpret=True),
           tol)
    mixed, agg = sparse.sparse_mix_aggregate_cuda(
        tidx, tw, torch.from_numpy(wrow), tX)
    jmixed, jagg = jsparse.sparse_mix_aggregate_pallas(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(wrow_pad), jX,
        chunk=chunk, interpret=True)
    assert mixed.dtype == tdt and agg.dtype == torch.float32
    _close(mixed, jmixed, tol)
    _close(agg, jagg[0], F32_TOL)


def _case(name, seed):
    A, idx, w, X, tau, active, weights = _ell_inputs(13, 37, seed)
    kw, m = {}, float(tau.sum())
    if "active" in name:
        kw["active"] = active
        m = float((tau * active).sum()) or 1.0
    if "weights" in name:
        kw["weights"] = weights
    if name == "m_zero":
        m = 0.0
    return A, idx, w, X, tau, m, kw


@pytest.mark.parametrize("case", ["plain", "active", "weights",
                                  "active_weights", "m_zero"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_sparse_ops_match_reference(case, dt):
    jdt, tdt = DTYPES[dt]
    A, idx, w, X, tau, m, kw = _case(case, seed=len(case))
    tol = F32_TOL if dt == "f32" else BF16_TOL
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    jX, tX = jnp.asarray(X, jdt), torch.from_numpy(X).to(tdt)
    jidx, jw = jnp.asarray(idx), jnp.asarray(w)
    tidx, tw = torch.from_numpy(idx), torch.from_numpy(w)
    jtau, ttau = jnp.asarray(tau), torch.from_numpy(tau)
    jm, tm = jnp.float32(m), torch.tensor(m)

    row = ops.combine_weights_ell(tidx, tw, ttau, tm, **tkw)
    _close(row, jops.combine_weights_ell(jidx, jw, jtau, jm, **jkw),
           F32_TOL)
    # and the dense definition it must agree with
    _close(row, ops.combine_weights(torch.from_numpy(A), ttau, tm, **tkw),
           F32_TOL)
    _close(ops.sparse_mix(tidx, tw, tX),
           jops.sparse_mix(jidx, jw, jX, chunk=128), tol)
    mixed, agg = ops.sparse_mix_aggregate(tidx, tw, ttau, tm, tX, **tkw)
    jmixed, jagg = jops.sparse_mix_aggregate(jidx, jw, jtau, jm, jX,
                                             chunk=128, **jkw)
    _close(mixed, jmixed, tol)
    _close(agg, jagg, F32_TOL)
    agg2 = ops.sparse_aggregate(tidx, tw, ttau, tm, tX, **tkw)
    _close(agg2, jops.sparse_aggregate(jidx, jw, jtau, jm, jX, chunk=128,
                                       **jkw), F32_TOL)
    if case == "m_zero":
        assert (row == 0).all() and (agg == 0).all() and (agg2 == 0).all()


def test_sparse_grouped_match_reference():
    _, idx, w, X, tau, active, _ = _ell_inputs(13, 64, seed=7)
    m = float((tau * active).sum())
    bufs = (X[:, :40], X[:, 40:])
    tbufs = (torch.from_numpy(bufs[0]).contiguous(),
             torch.from_numpy(bufs[1]).to(torch.bfloat16))
    jbufs = (jnp.asarray(bufs[0]), jnp.asarray(bufs[1], jnp.bfloat16))
    args = (torch.from_numpy(idx), torch.from_numpy(w), torch.from_numpy(tau),
            torch.tensor(m))
    jargs = (jnp.asarray(idx), jnp.asarray(w), jnp.asarray(tau),
             jnp.float32(m))
    mixed, rows = ops.sparse_mix_aggregate_grouped(
        *args, tbufs, active=torch.from_numpy(active))
    jmixed, jrows = jops.sparse_mix_aggregate_grouped(
        *jargs, jbufs, chunk=128, active=jnp.asarray(active))
    for got, want, tol in zip(mixed, jmixed, (F32_TOL, BF16_TOL)):
        _close(got, want, tol)
    for got, want in zip(rows, jrows):
        _close(got, want, F32_TOL)
    rows2 = ops.sparse_aggregate_grouped(*args, tbufs,
                                         active=torch.from_numpy(active))
    for got, want in zip(rows2, jrows):
        _close(got, want, F32_TOL)


def test_plain_versions_follow_the_slot_loop():
    """``sparse_mix_ref`` is the reference's ``_gather_mix`` in slot
    order, padding slots included: bitwise equal to a numpy loop of the
    same fp32 operations, and a non-finite payload row reaches exactly
    the rows that gather it (through padding slots too)."""
    _, idx, w, X, _, _, _ = _ell_inputs(11, 9, seed=2, max_deg=5)
    acc = np.zeros_like(X)
    for k in range(idx.shape[1]):
        acc = acc + w[:, k, None] * X[idx[:, k]]
    got = ref.sparse_mix_ref(torch.from_numpy(idx), torch.from_numpy(w),
                             torch.from_numpy(X))
    np.testing.assert_array_equal(got.numpy(), acc)
    X[0, 0] = np.inf
    got = ref.sparse_mix_ref(torch.from_numpy(idx), torch.from_numpy(w),
                             torch.from_numpy(X)).numpy()
    touches = (idx == 0).any(axis=1)
    assert (~np.isfinite(got[:, 0]) == touches).all()


def test_combine_row_segment_sum_is_deterministic_and_exact():
    """The segment sum takes a fixed order (no atomics): two calls agree
    bitwise, it matches ``index_add_`` to fp32 rounding, and padding
    slots -- even a hub-like ELL that is mostly padding -- neither
    change the row nor widen the table past the largest in-degree."""
    rng = np.random.default_rng(0)
    n, d_max = 400, 300
    idx = np.zeros((n, d_max), np.int32)
    w = np.zeros((n, d_max), np.float32)
    deg = rng.integers(1, 4, n)
    deg[0] = d_max                        # one hub row, the rest padding
    for i in range(n):
        idx[i, :deg[i]] = np.sort(rng.choice(n, deg[i], replace=False))
        w[i, :deg[i]] = rng.random(deg[i]) + 0.1
    tau = torch.from_numpy((rng.random(n) < 0.5).astype(np.float32))
    tidx, tw = torch.from_numpy(idx), torch.from_numpy(w)
    a = ops.combine_weights_ell(tidx, tw, tau, torch.tensor(7.0))
    b = ops.combine_weights_ell(tidx, tw, tau, torch.tensor(7.0))
    assert torch.equal(a, b)
    want = torch.zeros(n).index_add_(0, tidx.reshape(-1).long(),
                                     (tau[:, None] * tw).reshape(-1)) / 7.0
    torch.testing.assert_close(a, want, rtol=1e-6, atol=1e-7)


def test_wrappers_use_plain_versions_on_cpu():
    _, idx, w, X, _, _, _ = _ell_inputs(5, 8, seed=3)
    before = (sparse.sparse_mix_cuda.launches,
              sparse.sparse_mix_aggregate_cuda.launches)
    tidx, tw, tX = (torch.from_numpy(a) for a in (idx, w, X))
    assert torch.equal(sparse.sparse_mix_cuda(tidx, tw, tX),
                       ref.sparse_mix_ref(tidx, tw, tX))
    sparse.sparse_mix_aggregate_cuda(tidx, tw, torch.ones(5), tX)
    assert (sparse.sparse_mix_cuda.launches,
            sparse.sparse_mix_aggregate_cuda.launches) == before


# ---------------------------------------------------------------------------
# rounds and engine: the reference's parity sweep
# ---------------------------------------------------------------------------

def jquad_loss(params, batch):
    b, = batch
    return 0.5 * jnp.sum((params["x"] - b.mean(axis=0)) ** 2)


def quad_loss(params, batch):
    b, = batch
    return 0.5 * torch.sum((params["x"] - b.mean(dim=0)) ** 2)


def _batches(n, rounds, p=3, T=2, B=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, T, B, p)).astype(np.float32)
            for _ in range(rounds)]


def _run(plan, batches, backend, record_mixed=False, scan=False, x0=None):
    eng = make_engine(ExecutionConfig(backend=backend, scan=scan,
                                      record_mixed=record_mixed),
                      quad_loss, device="cpu")
    x0 = torch.zeros(batches[0].shape[-1]) if x0 is None else x0
    final, hist = eng.execute(plan, {"x": x0},
                              [(torch.from_numpy(b),) for b in batches])
    return final["x"], hist


def _history_rows(history):
    return [(r.t, r.m, r.m_actual, r.d2s, r.d2d, r.psi_bound, r.eta)
            for r in history.records]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("dropout", ["iid", "markov", "cluster"])
def test_sparse_backend_matches_dense_oracle(family, dropout):
    plan, jplan = _plans(family, dropout, sparse=True)
    dense_plan, _ = _plans(family, dropout, sparse=False)
    n, K = plan.n_clients, plan.n_rounds
    batches = _batches(n, K)
    jfinal, jhist = jmake_engine(JExec(backend="sparse", chunk=128),
                                 jquad_loss).execute(
        jplan, {"x": jnp.zeros(3)}, [(jnp.asarray(b),) for b in batches])
    oracle, ohist = _run(dense_plan, batches, "einsum")
    for record_mixed in (False, True):
        got, hist = _run(plan, batches, "sparse", record_mixed)
        assert _history_rows(hist) == _history_rows(jhist)
        assert _history_rows(hist) == _history_rows(ohist)
        assert hist.ledger.total_cost == jhist.ledger.total_cost
        np.testing.assert_allclose(got.numpy(), np.asarray(jfinal["x"]),
                                   atol=1e-5)
        np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=1e-5)


@pytest.mark.parametrize("backend", ["sparse", "sparse_aggregate"])
def test_sparse_scan_equals_sequential_bitwise(backend):
    plan, _ = _plans("k_regular", "markov", sparse=True)
    batches = _batches(plan.n_clients, plan.n_rounds)
    seq, hs = _run(plan, batches, backend, record_mixed=backend == "sparse")
    scn, hc = _run(plan, batches, backend, record_mixed=backend == "sparse",
                   scan=True)
    assert torch.equal(seq, scn)
    assert _history_rows(hs) == _history_rows(hc)


@pytest.mark.parametrize("record_mixed", [False, True])
def test_dense_plan_on_sparse_equals_sparsified_plan(record_mixed):
    dense_plan, _ = _plans("small_world", "cluster", sparse=False)
    batches = _batches(dense_plan.n_clients, dense_plan.n_rounds)
    a, ha = _run(dense_plan, batches, "sparse", record_mixed)
    b, hb = _run(dense_plan.sparsify(), batches, "sparse", record_mixed)
    assert torch.equal(a, b) and _history_rows(ha) == _history_rows(hb)
    # and a dense backend on a sparse plan densifies it
    c, _ = _run(dense_plan.sparsify(), batches, "fused")
    d, _ = _run(dense_plan, batches, "fused")
    assert torch.equal(c, d)


def test_sparse_plan_slice_resume():
    plan, _ = _plans("hub", "iid", sparse=True)
    tail = plan[1:]
    assert tail.is_sparse and tail.t0 == 1
    assert np.array_equal(tail.A_t.dense(), plan.A_t.dense()[1:])
    batches = _batches(plan.n_clients, plan.n_rounds)
    full, h_full = _run(plan, batches, "sparse")
    mid, _ = _run(plan[:1], batches[:1], "sparse")
    resumed, h_tail = _run(tail, batches[1:], "sparse", x0=mid)
    assert torch.equal(full, resumed)
    assert [r.t for r in h_tail.records] == \
        [r.t for r in h_full.records][1:]


@pytest.mark.parametrize("sparse_plan", [False, True])
def test_plan_slice_step_guard(sparse_plan):
    plan, _ = _plans("ring", "iid", sparse_plan)
    for sl in (slice(None, None, 2), slice(2, None, -1),
               slice(None, None, 0)):
        with pytest.raises(ValueError, match="step"):
            plan[sl]
    assert plan[::].n_rounds == plan.n_rounds
    assert plan[0:2:1].n_rounds == 2


def test_round_fn_zeroes_dropped_rows_before_the_mix():
    """'sparse' streams the payload as given, so the round masks dropped
    clients' rows first: their neighbours receive nothing from them."""
    _, idx, w, _, tau, active, _ = _ell_inputs(6, 3, seed=5)
    batches = (torch.from_numpy(_batches(6, 1)[0]),)
    args = (torch.from_numpy(idx), torch.from_numpy(w))
    tau, active = torch.from_numpy(tau), torch.from_numpy(active)
    m, eta = (tau * active).sum(), torch.tensor(0.1)
    _, mixed = make_round_fn(quad_loss, "sparse")(
        {"x": torch.zeros(3)}, batches, args, tau, m, eta, active)
    dense = np.zeros((6, 6), np.float32)
    for i in range(6):
        for k in range(idx.shape[1]):
            dense[i, idx[i, k]] += w[i, k]
    _, want = make_round_fn(quad_loss, "einsum")(
        {"x": torch.zeros(3)}, batches, torch.from_numpy(dense), tau, m,
        eta, active)
    torch.testing.assert_close(mixed["x"], want["x"], rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Algorithm 1 with the CNN: the port's server against the reference's
# ---------------------------------------------------------------------------

N, C, T, B, HW = 12, 3, 2, 4, 8


def _servers(backend, record_mixed, scan, family):
    ds = make_classification(n_samples=480, image_hw=HW, seed=0)
    parts = label_sorted_partition(ds, N, rng=np.random.default_rng(0))
    jparams = jcnn.init_cnn(0, image_hw=HW)
    cfg = dict(T=T, t_max=2, phi_max=0.3, seed=4,
               eta=lambda t: 0.05 * (0.8 ** t))
    jloss = partial(jcnn.l2_regularized_loss, jcnn.cnn_apply)
    js = JServer(jtopology.make_spec(family, n=N, c=C).build(), jloss,
                 jparams, JBatcher(ds, parts, T=T, batch_size=B),
                 JServerConfig(**cfg),
                 execution=JExec(backend=backend, scan=scan,
                                 record_mixed=record_mixed))
    ts = FederatedServer(
        topology.make_spec(family, n=N, c=C).build(),
        partial(cnn.l2_regularized_loss, cnn.cnn_apply),
        params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        FederatedBatcher(ds, parts, T=T, batch_size=B),
        ServerConfig(**cfg),
        execution=ExecutionConfig(backend=backend, scan=scan,
                                  record_mixed=record_mixed),
        device="cpu")
    return ts, js


@pytest.mark.parametrize("record_mixed,scan,family", [
    (False, False, "k_regular"), (True, False, "hub"),
    (True, True, "ring"), (False, True, "erdos_renyi")])
def test_cnn_slice_matches_reference_sparse_engine(record_mixed, scan,
                                                   family):
    ts, js = _servers("sparse", record_mixed, scan, family)
    th, jh = ts.run(), js.run()
    assert ts.effective_backend == js.effective_backend
    assert _history_rows(th) == _history_rows(jh)
    assert th.ledger.total_cost == jh.ledger.total_cost
    assert ts.last_plan.to_json() == js.last_plan.to_json()
    got = params_to_numpy(ts.params)
    want = jax.tree.map(np.asarray, js.params)
    for g, w in zip(tree_flatten(got)[0], jax.tree.leaves(want)):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# serialization and scale
# ---------------------------------------------------------------------------

def test_json_csr_round_trip_and_older_payloads():
    plan, jplan = _plans("erdos_renyi", "iid", sparse=True)
    payload = json.loads(plan.to_json())
    assert payload["version"] == 5 and payload["A_t"]["encoding"] == "csr"
    back = RoundPlan.from_json(plan.to_json())
    assert back.is_sparse and back.allclose(plan)
    payload["version"] = 4              # pre-quant payloads still load
    payload.pop("quant")
    assert RoundPlan.from_json(json.dumps(payload)).allclose(plan)
    payload["A_t"]["encoding"] = "coo"
    with pytest.raises(ValueError, match="encoding"):
        RoundPlan.from_json(json.dumps(payload))


def test_sparsify_densify_round_trip_is_bitwise():
    dense_plan, _ = _plans("small_world", "cluster", sparse=False)
    sparse_plan, _ = _plans("small_world", "cluster", sparse=True)
    assert dense_plan.sparsify().densify().allclose(dense_plan)
    assert sparse_plan.densify().sparsify().allclose(sparse_plan)
    assert not dense_plan.allclose(sparse_plan)    # representation counts
    assert dense_plan.sparsify().allclose(sparse_plan)


def test_sparse_plan_scales_to_100k_clients():
    """n = 100,000 (12,500 ring clusters of 8): the plan builds, equals
    the reference's, round-trips through JSON and runs one round on both
    sparse backends without an (n, n) array (a dense A_t would be 40 GB)."""
    n, c = 100_000, 12_500
    cfg = dict(T=1, t_max=1, m0=n // 10, seed=0, bound_kind="general")
    plan = RoundPlan.connectivity_aware(
        topology.make_spec("ring", n=n, c=c, hops=1).build(),
        ServerConfig(**cfg), sparse=True)
    assert isinstance(plan.A_t, SparseAseq)
    assert plan.A_t.nnz == 2 * n and plan.A_t.max_degree == 2
    text = plan.to_json()
    jplan = JRoundPlan.connectivity_aware(
        jtopology.make_spec("ring", n=n, c=c, hops=1).build(),
        JServerConfig(**cfg), sparse=True)
    assert text == jplan.to_json()
    assert RoundPlan.from_json(text).allclose(plan)
    batches = [np.random.default_rng(0).standard_normal((n, 1, 1, 3))
               .astype(np.float32)]
    a, hist = _run(plan, batches, "sparse")
    b, _ = _run(plan, batches, "sparse", record_mixed=True)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert len(hist.records) == 1 and hist.records[0].d2d == n


def test_train_cli_sparse_ring_matches_reference(tmp_path, capsys):
    args = ["--model", "logreg", "--rounds", "2", "--n", "20",
            "--clusters", "4", "--samples", "400", "--T", "2", "--batch",
            "4", "--quiet", "--backend", "sparse", "--topology",
            "ring:hops=1", "--dropout", "0.2", "--dropout-kind", "markov"]
    out, jout = tmp_path / "t.json", tmp_path / "j.json"
    assert train.main(args + ["--device", "cpu", "--out", str(out)]) == 0
    assert "sparse_aggregate backend" in capsys.readouterr().out
    assert jtrain.main(args + ["--out", str(jout)]) == 0
    a, b = json.loads(out.read_text()), json.loads(jout.read_text())
    assert a["total_cost"] == b["total_cost"]
    assert [(r["m"], r["d2s"], r["d2d"]) for r in a["rounds"]] == \
        [(r["m"], r["d2s"], r["d2d"]) for r in b["rounds"]]
    np.testing.assert_allclose([r["test_loss"] for r in a["rounds"]],
                               [r["test_loss"] for r in b["rounds"]],
                               rtol=1e-4)
