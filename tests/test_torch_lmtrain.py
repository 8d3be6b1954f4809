"""Federated LM training in the port (``core.rounds`` with
``Model.loss``, remat, the vmap-safe MoE, the token data) against the JAX
reference on the CPU.

The reference's parameters are carried into the port through numpy
(``models.convert.params_from_numpy``), the tokens and the trajectory
are drawn from a numpy seed, and both packages train the same reduced
configs.  Tolerances: every round against the reference's
``make_round_fn`` / ``make_scanned_rounds(model.loss)``: ``rtol=2e-4,
atol=2e-5`` (the reference's mesh helper's: fp32 sums in other orders,
here through T local steps); quantized rounds (int8, nearest) the same
with an allowance of one grid step where a rounding decision flipped
(``tests/test_torch_quant.py``), counted and kept rare.  Bitwise:
``make_token_stream`` / ``lm_batches``, remat on == off, scanned ==
sequential.  MoE under ``vmap``: ``moe_impl='ragged'`` takes the dense
oracle there, bitwise (the reduced MoE configs train ``dense``, as the
reference's do: its ``ragged_dot`` has no batching rule on the installed
jax).  The reference's oracle outputs
are computed once for the module.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import rounds as jrounds
from repro.core.server import FederatedServer as JServer
from repro.core.server import ServerConfig as JServerConfig
from repro.data.loader import lm_batches as j_lm_batches
from repro.data.synthetic import make_token_stream as j_token_stream
from repro.fl import packing as jpacking
from repro.models.model import Model as JModel
from repro import topology as jtopology
from repro_torch import topology
from repro_torch.configs import arch_names, get_config
from repro_torch.core.pytree import tree_flatten, tree_leaves, tree_map
from repro_torch.core.rounds import (MIXING_BACKENDS, SPARSE_BACKENDS,
                                     client_deltas, make_round_fn,
                                     make_scanned_rounds)
from repro_torch.core.server import FederatedServer, ServerConfig
from repro_torch.core.sparse import SparseA, SparseAseq
from repro_torch.data import lm_batches, make_token_stream
from repro_torch.fl import packing
from repro_torch.fl.engine import ExecutionConfig
from repro_torch.kernels.mixing.ops import combine_weights
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model

ORACLE = dict(rtol=2e-4, atol=2e-5)
N, T, B, S, K = 4, 2, 2, 16, 2
SWEEP_ARCHS = ("stablelm-1.6b", "phi3.5-moe-42b-a6.6b")
FAMILIES = tuple(arch_names())
QUANT = ("einsum", "fused")


def _cfgs(arch):
    """(reference, port) reduced configs of ``arch``, equal field for
    field."""
    jcfg, cfg = j_get_config(arch, reduced=True), get_config(arch,
                                                           reduced=True)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def _trajectory(cfg, seed):
    """K rounds: tokens (K, n, T, B, S) x / y [, prefix], 2-cluster
    equal-neighbour A, sampled tau (never empty), m, eta."""
    from repro.core.adjacency import block_diagonal, equal_neighbor_matrix
    from repro.core.graphs import k_regular_digraph

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (K, N, T, B, S + 1)) \
        .astype(np.int32)
    batch = (toks[..., :-1], toks[..., 1:])
    if cfg.frontend:
        batch += (rng.standard_normal((K, N, T, B, cfg.frontend_len,
                                       cfg.frontend_dim))
                  .astype(np.float32),)
    A = np.stack([block_diagonal([equal_neighbor_matrix(
        k_regular_digraph(N // 2, 1, rng)) for _ in range(2)])
        .astype(np.float32) for _ in range(K)])
    tau = (rng.random((K, N)) < 0.7).astype(np.float32)
    tau[:, 0] = 1.0
    m = tau.sum(1).astype(np.float32)
    eta = np.asarray([0.05 / (1 + 0.5 * t) for t in range(K)], np.float32)
    return batch, A, tau, m, eta


def _t(tree):
    return tree_map(torch.from_numpy, tree)


def _quant(QuantSpec):
    return QuantSpec(storage="int8", block=128)


@functools.lru_cache(maxsize=None)
def _oracle(name, K_run=1):
    """The reference's single-host rounds (einsum) of ``name``: its
    params, the trajectory, and the params after each of ``K_run``
    rounds (leaves in tree order).  The sweep's archs run the K-round
    scan only (its round 0 is the family test's round)."""
    if K_run == 1 and name in SWEEP_ARCHS:
        jp, traj, seq = _oracle(name, K)
        return jp, traj, seq[:1]
    jcfg, cfg = _cfgs(name)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    batch, A, tau, m, eta = _trajectory(cfg, 1)
    jb = tuple(jnp.asarray(b) for b in batch)
    if K_run == 1:
        p, _ = jrounds.make_round_fn(jm.loss)(
            jp, tuple(b[0] for b in jb), jnp.asarray(A[0]),
            jnp.asarray(tau[0]), jnp.float32(m[0]), jnp.float32(eta[0]))
        seq = [[np.asarray(x) for x in jax.tree.leaves(p)]]
    else:
        _, ps = jrounds.make_scanned_rounds(jm.loss, K_run)(
            jp, jb, jnp.asarray(A), jnp.asarray(tau), jnp.asarray(m),
            jnp.asarray(eta))
        seq = [[np.asarray(x[t]) for x in jax.tree.leaves(ps)]
               for t in range(K_run)]
    return jax.tree.map(np.asarray, jp), (batch, A, tau, m, eta), seq


@functools.lru_cache(maxsize=None)
def _quant_oracle(name, carry=False):
    """The reference's quantized einsum rounds (K sequential) of
    ``name`` and, a round at a time, one grid step of every value summed
    over the clients with the combine row's weights (the port's
    quantizer on the port's deltas, as ``tests/test_torch_quant.py``).
    With ``carry`` a client's previous grid step counts too, at its
    weight this round: a rounding decision that flipped in round t - 1
    (on a client whose weight was 0 then) stays in that client's
    error-feedback residual, and the residual is sent in round t."""
    jcfg, cfg = _cfgs(name)
    jm, m_ = JModel(jcfg), Model(cfg, device="cpu")
    jp0, (batch, A, tau, m, eta), _ = _oracle(name, K)
    jq, q = _quant(jpacking.QuantSpec), _quant(packing.QuantSpec)
    jspec = jpacking.pack_spec(jax.tree.map(
        lambda x: jax.ShapeDtypeStruct((N,) + x.shape, x.dtype), jp0),
        quant=jq)
    jfn = jrounds.make_round_fn(jm.loss, quant=jq)
    tp = params_from_numpy(jp0, "cpu")
    spec = packing.pack_spec(tree_map(
        lambda x: torch.empty((N,) + tuple(x.shape), device="meta"), tp),
        quant=q)
    tfn = make_round_fn(m_.loss, "einsum", quant=q)
    js, ts = jpacking.init_quant_state(jspec, N), \
        packing.init_quant_state(spec, N)
    jp, allow, out = jp0, torch.zeros(spec.padded), []
    prev = torch.zeros(N, spec.padded)
    for t in range(K):
        tb = tuple(torch.from_numpy(b[t]) for b in batch)
        xq = packing.pack(client_deltas(m_.loss, tp, tb, torch.tensor(
            eta[t])), spec)[0] + ts[0][0]
        steps = (xq.reshape(N, -1, q.block).abs().amax(2) / q.qmax) \
            .repeat_interleave(q.block, 1)
        w = combine_weights(torch.from_numpy(A[t]), torch.from_numpy(tau[t]),
                            torch.tensor(m[t])).abs()
        allow += w @ (steps + prev if carry else steps)
        prev = steps
        tp, _, ts = tfn(tp, tb, torch.from_numpy(A[t]),
                        torch.from_numpy(tau[t]), torch.tensor(m[t]),
                        torch.tensor(eta[t]), None, ts)
        jp, _, js = jfn(jp, tuple(jnp.asarray(b[t]) for b in batch),
                        jnp.asarray(A[t]), jnp.asarray(tau[t]),
                        jnp.float32(m[t]), jnp.float32(eta[t]), None, js)
        out.append(([np.asarray(x) for x in jax.tree.leaves(jp)],
                    [a.numpy() for a in tree_flatten(packing.unpack_row(
                        allow * 1.01 + 1e-7, spec))[0]]))
    return out


def _flips_allowed(got, want, allow, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    off = ~np.isclose(got, want, **tol)
    assert (np.abs(got - want)[off] <= np.asarray(allow)[off]).all()
    return int(off.sum())


def _A_arg(backend, A):
    if backend in SPARSE_BACKENDS:
        idx, w = (SparseAseq.from_dense(A) if A.ndim == 3
                  else SparseA.from_dense(A)).ell()
        return torch.from_numpy(idx), torch.from_numpy(w)
    return torch.from_numpy(A)


def _close(got_tree, want_leaves, tol=ORACLE):
    got = [x.detach().float().numpy() for x in tree_leaves(got_tree)]
    assert len(got) == len(want_leaves)
    for a, b in zip(got, want_leaves):
        np.testing.assert_allclose(a, b, **tol)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_tokens,vocab,seed", [(3000, 512, 0),
                                                 (2048, 100352, 7)])
def test_token_stream_is_the_reference_stream(n_tokens, vocab, seed):
    got = make_token_stream(n_tokens=n_tokens, vocab=vocab, seed=seed)
    want = j_token_stream(n_tokens=n_tokens, vocab=vocab, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_lm_batches_are_the_reference_batches():
    stream = make_token_stream(n_tokens=4000, vocab=300, seed=1)
    xs, ys = lm_batches(stream, np.random.default_rng(5), 3, 2, 4, 40,
                        device="cpu")
    jx, jy = j_lm_batches(stream, np.random.default_rng(5), 3, 2, 4, 40)
    assert xs.dtype == ys.dtype == torch.int32 and xs.device.type == "cpu"
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jy))
    with pytest.raises(ValueError, match="too short"):
        lm_batches(stream[:100], np.random.default_rng(0), 3, 1, 1, 40)


# ---------------------------------------------------------------------------
# rounds against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_family_round_matches_the_reference(name):
    """One einsum round of every family's reduced config (MoE dense and
    ragged, MLA, SSD, hybrid, the audio / vlm prefix batches)."""
    _, cfg = _cfgs(name)
    jp, (batch, A, tau, m, eta), seq = _oracle(name)
    fn = make_round_fn(Model(cfg, device="cpu").loss, "einsum")
    p, _ = fn(params_from_numpy(jp, "cpu"),
              tuple(torch.from_numpy(b[0]) for b in batch),
              torch.from_numpy(A[0]), torch.from_numpy(tau[0]),
              torch.tensor(m[0]), torch.tensor(eta[0]))
    _close(p, seq[0])


@pytest.mark.parametrize("arch", SWEEP_ARCHS)
@pytest.mark.parametrize("backend", MIXING_BACKENDS)
@pytest.mark.parametrize("scan", [False, True], ids=["seq", "scan"])
def test_backend_matches_the_reference(arch, backend, scan):
    _, cfg = _cfgs(arch)
    jp, (batch, A, tau, m, eta), seq = _oracle(arch, K)
    loss = Model(cfg, device="cpu").loss
    p0 = params_from_numpy(jp, "cpu")
    if scan:
        _, ps = make_scanned_rounds(loss, K, backend)(
            p0, _t(batch), _A_arg(backend, A), *_t((tau, m, eta)))
        outs = [tree_map(lambda x: x[t], ps) for t in range(K)]
    else:
        fn, p, outs = make_round_fn(loss, backend), p0, []
        for t in range(K):
            p, _ = fn(p, tuple(torch.from_numpy(b[t]) for b in batch),
                      _A_arg(backend, A[t]), torch.from_numpy(tau[t]),
                      torch.tensor(m[t]), torch.tensor(eta[t]))
            outs.append(p)
    for t in range(K):
        _close(outs[t], seq[t])


@pytest.mark.parametrize("arch", SWEEP_ARCHS)
@pytest.mark.parametrize("backend", QUANT)
@pytest.mark.parametrize("scan", [False, True], ids=["seq", "scan"])
def test_quantized_backend_matches_the_reference(arch, backend, scan):
    _, cfg = _cfgs(arch)
    jp, (batch, A, tau, m, eta), _ = _oracle(arch, K)
    ref = _quant_oracle(arch)
    loss = Model(cfg, device="cpu").loss
    q = _quant(packing.QuantSpec)
    p0 = params_from_numpy(jp, "cpu")
    spec = packing.pack_spec(tree_map(
        lambda x: torch.empty((N,) + tuple(x.shape), device="meta"), p0),
        quant=q)
    state = packing.init_quant_state(spec, N)
    if scan:
        _, ps, _ = make_scanned_rounds(loss, K, backend, quant=q)(
            p0, _t(batch), torch.from_numpy(A), *_t((tau, m, eta)), None,
            state)
        outs = [tree_map(lambda x: x[t], ps) for t in range(K)]
    else:
        fn, p, outs = make_round_fn(loss, backend, quant=q), p0, []
        for t in range(K):
            p, _, state = fn(p, tuple(torch.from_numpy(b[t])
                                      for b in batch),
                             torch.from_numpy(A[t]),
                             torch.from_numpy(tau[t]), torch.tensor(m[t]),
                             torch.tensor(eta[t]), None, state)
            outs.append(p)
    flips = total = 0
    for t in range(K):
        want, allow = ref[t]
        for a, w, al in zip(tree_leaves(outs[t]), want, allow):
            flips += _flips_allowed(a.numpy(), w, al, ORACLE)
            total += a.numpy().size
    assert flips <= 1e-3 * total


def test_server_trains_an_lm_like_the_reference():
    """``FederatedServer`` with ``ExecutionConfig(model_cfg=)`` and no
    loss function (``LocalEngine`` builds ``Model(model_cfg).loss``) on
    token batches from ``make_token_stream`` / ``lm_batches``: History
    equal to the reference's, params within the oracle tolerance."""
    jcfg, cfg = _cfgs("stablelm-1.6b")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(3))
    stream = make_token_stream(n_tokens=1 << 12, vocab=cfg.vocab_size,
                               seed=2)
    kw = dict(n=N, c=2, k_range=(1, 2), p_fail=0.1)

    def scfg(C):
        return C(T=T, t_max=2, phi_max=1.0, bound_kind="regular", seed=4,
                 eta=lambda t: 0.05)

    ts = FederatedServer(
        topology.make_spec("k_regular", **kw).build(), None,
        params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
        lambda r, t: lm_batches(stream, r, N, T, B, S), scfg(ServerConfig),
        execution=ExecutionConfig(backend="fused", model_cfg=cfg),
        device="cpu")
    th = ts.run()
    js = JServer(jtopology.make_spec("k_regular", **kw).build(), jm.loss,
                 jp, lambda r, t: j_lm_batches(stream, r, N, T, B, S),
                 scfg(JServerConfig))
    jh = js.run()
    cols = [(r.t, r.m, r.m_actual, r.psi_bound, r.d2s, r.d2d, r.eta)
            for r in jh.records]
    assert [(r.t, r.m, r.m_actual, r.psi_bound, r.d2s, r.d2d, r.eta)
            for r in th.records] == cols
    assert ts.effective_backend == "aggregate"
    _close(ts.params, [np.asarray(x) for x in jax.tree.leaves(js.params)])


# ---------------------------------------------------------------------------
# the port's own pins
# ---------------------------------------------------------------------------

def _one_round(cfg, seed=1, n=2):
    m = Model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    batch, A, tau, mm, eta = _trajectory(cfg, seed)
    b = tuple(torch.from_numpy(x[0][:n]) for x in batch)
    return make_round_fn(m.loss, "einsum")(
        p, b, torch.from_numpy(A[0][:n, :n]), torch.ones(n),
        torch.tensor(float(n)), torch.tensor(eta[0]))[0]


@pytest.mark.parametrize("arch", arch_names())
def test_remat_changes_memory_only(arch):
    """``remat=True`` (each stacked layer / zamba2 group, each attention
    query chunk and each loss chunk recomputed in the backward pass)
    gives the same bits as ``remat=False`` under ``vmap(grad)``."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              attn_impl="chunked", attn_chunk=4,
                              loss_chunk=8)
    off = _one_round(dataclasses.replace(cfg, remat=False))
    on = _one_round(dataclasses.replace(cfg, remat=True))
    for a, b in zip(tree_leaves(on), tree_leaves(off)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"])
def test_moe_ragged_matches_dense_under_vmap(arch):
    """Under ``vmap(grad)`` a ragged config runs the dense oracle (no
    grouped GEMM launches) and gives its bits; the same layer outside
    ``vmap`` takes the ragged path."""
    cfg = get_config(arch, reduced=True)
    before = dict(moe.expert_matmul.routes)
    ragged = _one_round(dataclasses.replace(cfg, moe_impl="ragged"), n=N)
    assert moe.expert_matmul.routes == before
    dense = _one_round(dataclasses.replace(cfg, moe_impl="dense"), n=N)
    for a, b in zip(tree_leaves(ragged), tree_leaves(dense)):
        assert torch.equal(a, b)
    rcfg = dataclasses.replace(cfg, moe_impl="ragged")
    p = moe.moe_init(torch.Generator().manual_seed(0), rcfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (N, 1, 8, cfg.d_model)).astype(np.float32))
    out = torch.func.vmap(lambda xi: moe.moe_apply(rcfg, p, xi)[0])(x)
    assert moe.expert_matmul.routes == before
    want = torch.stack([moe.moe_apply(rcfg, p, xi)[0] for xi in x])
    assert moe.expert_matmul.routes["loop"] > before["loop"]
    np.testing.assert_allclose(out.numpy(), want.numpy(), **ORACLE)


def test_expert_route_rule():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert moe.expert_route(torch.bfloat16, cuda) == "grouped_mm"
    assert moe.expert_route(torch.float32, cuda) == "loop"
    assert moe.expert_route(torch.bfloat16, cpu) == "loop"
    seen = []
    torch.func.vmap(lambda x: seen.append(moe._under_vmap()) or x)(
        torch.ones(2, 3))
    assert seen == [True] and not moe._under_vmap()


def test_bf16_rounds_keep_their_dtype():
    cfg = dataclasses.replace(get_config("stablelm-1.6b", reduced=True),
                              dtype="bfloat16", remat=True,
                              attn_impl="chunked", loss_chunk=8)
    out = _one_round(cfg)
    assert all(x.dtype == torch.bfloat16 and torch.isfinite(x).all()
               for x in tree_leaves(out))


# the stablelm-2-1.6b training cell's limit on the first update's per-leaf
# norms (chipbench/workloads/stablelm2.fedtrain_4k.json)
FIRST_UPDATE_REL = 0.0034


def update_norm_gap(got, want) -> float:
    """The worst leaf's gap of update norms, over the larger of its norm in
    ``want`` and the median leaf's: the benchmark's ``first_update_rel``
    (``chipbench/harness.py::compare``)."""
    ng = [float(x.double().norm()) for x in tree_leaves(got)]
    nw = [float(x.double().norm()) for x in tree_leaves(want)]
    med = float(np.median(nw))
    return max(abs(a - b) / max(b, med) for a, b in zip(ng, nw))


def _deltas(cfg, S=64, n=2, steps=2):
    m = Model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x, y = (torch.randint(0, cfg.vocab_size, (n, steps, 1, S), generator=g)
            for _ in range(2))
    return client_deltas(m.loss, p, (x, y), torch.tensor(0.05))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_through_flash_matches_chunked(dtype):
    """A round trains through ``attn_impl='flash'`` (on the CPU the flash
    Function's plain forward and backward, under ``vmap(grad)`` and
    remat) and gives what ``'chunked'`` gives: the oracle's tolerance in
    fp32; in bf16, where the two round the softmax weights differently,
    client deltas whose per-leaf norms agree within the training cell's
    limit."""
    cfg = dataclasses.replace(get_config("stablelm-1.6b", reduced=True),
                              dtype=dtype, remat=True, loss_chunk=16,
                              attn_chunk=16)
    flash, chunked = (dataclasses.replace(cfg, attn_impl=a)
                      for a in ("flash", "chunked"))
    if dtype == "float32":
        for a, b in zip(tree_leaves(_one_round(flash)),
                        tree_leaves(_one_round(chunked))):
            torch.testing.assert_close(a, b, **ORACLE)
        return
    assert update_norm_gap(_deltas(flash), _deltas(chunked)) < \
        FIRST_UPDATE_REL