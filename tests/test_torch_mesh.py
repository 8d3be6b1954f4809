"""The port's mesh runtime (``repro_torch.fl.distributed``,
``repro_torch.launch.mesh``, ``MeshEngine``) on four gloo CPU ranks,
against the reference's single-host oracle.

The reference's own mesh tests do not run on this jax, so the mesh is
held, as its helper holds the reference's
(``tests/helpers/mesh_scan_equivalence.py``), against the single-host
``repro.core.rounds`` oracle on the same trajectory (the helper's
``_trajectory`` recipe, copied: FedAvg, then a round that samples no
one, then random 2-cluster rounds) and the same weights, carried through
numpy.  Four ranks are spawned once for the module (this file run as a
script: ``python tests/test_torch_mesh.py worker RANK DIR``); each runs
every case on meshes (2, 2, 1) and (1, 4, 1) and the parent compares.

Tolerances: every schedule against the oracle ``rtol=2e-4, atol=2e-5``
(the reference helper's: fp32 sums in other orders); quantized rounds
(int8, nearest) the same with an allowance of one grid step where a
rounding decision flipped (the port and XLA compute the deltas a few
ulps apart; ``tests/test_torch_quant.py``), counted and kept rare.
Bitwise: scanned == sequential, all-ones ``active`` == ``None``, every
rank's params equal, and ``MeshEngine``'s History against
``LocalEngine``'s on the host columns.
"""

import dataclasses
import hashlib
import os
import subprocess
import sys
import types
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
MESHES = {"2x2x1": (2, 2, 1), "1x4x1": (1, 4, 1)}
MIXINGS = ("ring", "gather", "einsum", "fused", "fused_rs")
QMIX = ("fused", "fused_rs")
SERVER_CASES = (("einsum", False), ("fused", False), ("ring", False),
                ("fused_rs", True))
N, T, B, S, K, KA, KQ = 4, 2, 2, 16, 3, 2, 2
ORACLE = dict(rtol=2e-4, atol=2e-5)
WORLD, JOIN_S = 4, 240


def _cfg(pkg_get_config):
    return pkg_get_config("stablelm-1.6b").reduced(d_model=64, vocab=128)


def _quant(QuantSpec):
    return QuantSpec(storage="int8", block=128)


# ---------------------------------------------------------------------------
# the ranks (this file run as a script)
# ---------------------------------------------------------------------------

def _worker(rank: int, out: Path) -> None:
    import torch.distributed as dist

    from repro_torch import topology
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_flatten, tree_unflatten
    from repro_torch.core.server import FederatedServer, ServerConfig
    from repro_torch.data import lm_batches, make_token_stream
    from repro_torch.fl import distributed as D
    from repro_torch.fl.engine import ExecutionConfig
    from repro_torch.fl.packing import QuantSpec
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import Model

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=JOIN_S))
    inp = np.load(out / "inputs.npz")
    cfg = _cfg(get_config)
    _, treedef = tree_flatten(Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)))
    n_leaves = len([k for k in inp.files if k.startswith("p")])
    params = tree_unflatten(treedef, [torch.from_numpy(inp[f"p{i}"])
                                      for i in range(n_leaves)])
    toks, A, tau, m, eta, act, tau1, m_act, A_pod, tau_pod = (
        torch.from_numpy(inp[k]) for k in
        ("toks", "A", "tau", "m", "eta", "act", "tau1", "m_act", "A_pod",
         "tau_pod"))
    q = _quant(QuantSpec)
    res, digest = {}, {}

    def keep(key, tree):
        leaves = [x.clone() for x in tree_flatten(tree)[0]]
        digest[key] = [hashlib.sha1(x.numpy().tobytes()).hexdigest()
                       for x in leaves]
        if rank == 0:
            res[key] = leaves

    for mname, shape in MESHES.items():
        mesh = make_debug_mesh(shape, device="cpu")
        for mixing in MIXINGS:
            tag = f"{mname}/{mixing}"
            step = D.make_train_step(cfg, mesh, mixing=mixing)
            p = params
            for t in range(K):
                p = step(p, toks[t], A[t], tau[t], m[t], eta[t])
                keep(f"{tag}/seq{t}", p)
            scanned = D.make_scanned_train_steps(cfg, mesh, K,
                                                 mixing=mixing)
            final, seq = scanned(params, toks, A, tau, m, eta)
            keep(f"{tag}/scan", seq)
            keep(f"{tag}/scan_final", final)
            p = params
            for t in range(KA):
                p = step(p, toks[t], A[t], tau1[t], m_act[t], eta[t],
                         active=act[t])
            keep(f"{tag}/active", p)
            scanned = D.make_scanned_train_steps(cfg, mesh, KA,
                                                 mixing=mixing)
            keep(f"{tag}/active_scan",
                 scanned(params, toks[:KA], A[:KA], tau1[:KA], m_act[:KA],
                         eta[:KA], active_seq=act[:KA])[0])
            if mname == "1x4x1":
                # one pod of four: an asymmetric A, where the ring's hop
                # order and the gather's row block matter
                keep(f"{tag}/pod", step(params, toks[2], A_pod, tau_pod,
                                        tau_pod.sum().clamp_min(1.0),
                                        eta[2]))
            keep(f"{tag}/plain0", step(params, toks[0], A[0], tau1[0],
                                       torch.tensor(float(N)), eta[0]))
            keep(f"{tag}/ones0", step(params, toks[0], A[0], tau1[0],
                                      torch.tensor(float(N)), eta[0],
                                      active=torch.ones(N)))
            if mixing in QMIX:
                qstep = D.make_train_step(cfg, mesh, mixing=mixing, quant=q)
                qs = D.init_rank_quant_state(params, q, mesh, mixing)
                p = params
                for t in range(KQ):
                    p, qs = qstep(p, toks[t], A[t], tau[t], m[t], eta[t],
                                  qstate=qs)
                    keep(f"{tag}/q{t}", p)
                qscan = D.make_scanned_train_steps(cfg, mesh, KQ,
                                                   mixing=mixing, quant=q)
                keep(f"{tag}/qscan", qscan(
                    params, toks[:KQ], A[:KQ], tau[:KQ], m[:KQ], eta[:KQ],
                    qstate=D.init_rank_quant_state(params, q, mesh,
                                                   mixing))[0])
        dist.barrier()

    mesh = make_debug_mesh(MESHES["2x2x1"], device="cpu")
    for mixing, scan in SERVER_CASES:
        server, hist = _server(
            topology, FederatedServer, ServerConfig, lm_batches,
            make_token_stream, params,
            ExecutionConfig(backend=mixing, scan=scan, mesh=mesh,
                            model_cfg=cfg), cfg, mesh=True)
        keep(f"server/{mixing}/{scan}", server.params)
        res[f"server/{mixing}/{scan}/hist"] = _columns(hist)
    torch.save({"res": res, "digest": digest}, out / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _server(topology, FederatedServer, ServerConfig, lm_batches,
            make_token_stream, params, execution, cfg, mesh):
    """The reference example's run at test size: Algorithm 1 on
    ``k_regular(n=4, c=2, k_range=(1, 2))``, token batches from
    ``make_token_stream`` / ``lm_batches``; the mesh takes (n, T, B,
    S+1) token arrays, ``LocalEngine`` the (x, y) pair."""
    network = topology.make_spec("k_regular", n=N, c=2, k_range=(1, 2),
                                 p_fail=0.1).build()
    scfg = ServerConfig(T=T, t_max=3, phi_max=1.0, bound_kind="regular",
                        seed=0, eta=lambda t: 0.05 / (1 + 0.5 * t))
    stream = make_token_stream(n_tokens=1 << 12, vocab=cfg.vocab_size,
                               seed=0)

    def sampler(rng, t):
        xs, ys = lm_batches(stream, rng, N, T, B, S)
        if not mesh:
            return xs, ys
        return torch.cat([xs, ys[..., -1:]], dim=-1)

    server = FederatedServer(network, None, params, sampler, scfg,
                             algorithm="semidec", execution=execution,
                             device=None if mesh else "cpu")
    return server, server.run()


def _columns(hist):
    return [(r.t, r.m, r.m_actual, r.psi_bound, r.d2s, r.d2d, r.eta)
            for r in hist.records]


# ---------------------------------------------------------------------------
# the parent: inputs, the reference oracle, one spawn for the module
# ---------------------------------------------------------------------------

def _trajectory(rng, n, T, B, S, K):
    """The reference helper's recipe: round 0 is FedAvg (A = I), round 1
    samples nobody (tau = 0, m clamped to 1), later rounds use fresh
    random 2-cluster topologies."""
    from repro.core.adjacency import block_diagonal, equal_neighbor_matrix
    from repro.core.graphs import k_regular_digraph

    toks = rng.integers(0, 128, size=(K, n, T, B, S + 1)).astype(np.int32)
    As, taus, ms = [], [], []
    for t in range(K):
        if t == 0:
            A = np.eye(n, dtype=np.float32)
        else:
            blocks = [equal_neighbor_matrix(
                k_regular_digraph(n // 2, 1, rng)) for _ in range(2)]
            A = block_diagonal(blocks).astype(np.float32)
        if t == 1:
            tau = np.zeros(n, np.float32)          # no client sampled
        else:
            tau = (rng.random(n) < 0.7).astype(np.float32)
            if tau.sum() == 0:
                tau[0] = 1.0
        As.append(A)
        taus.append(tau)
        ms.append(max(1.0, float(tau.sum())))
    eta = np.asarray([0.05 / (1 + 0.5 * t) for t in range(K)], np.float32)
    return toks, np.stack(As), np.stack(taus), np.asarray(ms, np.float32), \
        eta


def _flips_allowed(got, want, allow, tol):
    """``got`` allclose ``want`` except where a value may differ by up to
    ``allow`` (a flipped rounding decision); returns how many did."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    off = ~np.isclose(got, want, **tol)
    assert (np.abs(got - want)[off] <= np.asarray(allow)[off]).all()
    return int(off.sum())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.core import rounds as jrounds
    from repro.fl import packing as jpacking
    from repro.models.model import Model as JModel
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_flatten
    from repro_torch.core.rounds import client_deltas, make_round_fn
    from repro_torch.fl import packing
    from repro_torch.fl.packing import QuantSpec
    from repro_torch.kernels.mixing.ops import combine_weights
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import Model

    out = tmp_path_factory.mktemp("mesh")
    jcfg, cfg = _cfg(j_get_config), _cfg(get_config)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    leaves = [np.asarray(x) for x in jax.tree.leaves(jp)]
    rng = np.random.default_rng(0)
    toks, A, tau, m, eta = _trajectory(rng, N, T, B, S, K)
    act = np.asarray([[1, 0, 1, 1], [1, 1, 0, 0]], np.float32)
    tau1 = np.ones((K, N), np.float32)
    m_act = np.concatenate([np.maximum((tau1[:KA] * act).sum(1), 1.0),
                            np.ones(K - KA)]).astype(np.float32)
    A_pod = rng.random((N, N)).astype(np.float32)
    A_pod /= A_pod.sum(1, keepdims=True)       # dense, asymmetric
    tau_pod = np.asarray([1, 0, 1, 1], np.float32)
    np.savez(out / "inputs.npz", toks=toks, A=A, tau=tau, m=m, eta=eta,
             act=act, tau1=tau1, m_act=m_act, A_pod=A_pod, tau_pod=tau_pod,
             **{f"p{i}": x for i, x in enumerate(leaves)})
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(HERE), "worker", str(r),
                               str(out)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        # meanwhile: the reference's single-host oracle
        jb = (jnp.asarray(toks[..., :-1]), jnp.asarray(toks[..., 1:]))
        oracle = jrounds.make_scanned_rounds(jm.loss, K)
        _, jseq = oracle(jp, jb, jnp.asarray(A), jnp.asarray(tau),
                         jnp.asarray(m), jnp.asarray(eta))
        ref = {"seq": [[np.asarray(x[t]) for x in jax.tree.leaves(jseq)]
                       for t in range(K)]}
        jround = jrounds.make_round_fn(jm.loss)
        p = jp
        for t in range(KA):
            p, _ = jround(p, tuple(x[t] for x in jb), jnp.asarray(A[t]),
                          jnp.asarray(tau1[t]), jnp.float32(m_act[t]),
                          jnp.float32(eta[t]), jnp.asarray(act[t]))
        ref["active"] = [np.asarray(x) for x in jax.tree.leaves(p)]
        p, _ = jround(jp, tuple(x[2] for x in jb), jnp.asarray(A_pod),
                      jnp.asarray(tau_pod), jnp.float32(tau_pod.sum()),
                      jnp.float32(eta[2]))
        ref["pod"] = [np.asarray(x) for x in jax.tree.leaves(p)]
        # the quantized oracle, and one grid step of every value a round
        # (the port's quantizer on the port's single-host deltas), summed
        # over the clients with the combine row's weights
        jq, q = _quant(jpacking.QuantSpec), _quant(QuantSpec)
        jqr = jrounds.make_round_fn(jm.loss, quant=jq)
        jspec = jpacking.pack_spec(jax.tree.map(
            lambda x: jax.ShapeDtypeStruct((N,) + x.shape, x.dtype), jp),
            quant=jq)
        js = jpacking.init_quant_state(jspec, N)
        tm = Model(cfg, device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        spec = packing.pack_spec(tree_flatten_like(tp, N), quant=q)
        ts = packing.init_quant_state(spec, N)
        tqr = make_round_fn(tm.loss, "einsum", quant=q)
        allow = torch.zeros(spec.padded)
        p, ref["q"] = jp, []
        for t in range(KQ):
            tb = (torch.from_numpy(toks[t][..., :-1]),
                  torch.from_numpy(toks[t][..., 1:]))
            xq = packing.pack(client_deltas(
                tm.loss, tp, tb, torch.tensor(eta[t])), spec)[0] + ts[0][0]
            steps = (xq.reshape(N, -1, q.block).abs().amax(2) / q.qmax) \
                .repeat_interleave(q.block, 1)
            w = combine_weights(torch.from_numpy(A[t]),
                                torch.from_numpy(tau[t]),
                                torch.tensor(m[t])).abs()
            allow += w @ steps
            tp, _, ts = tqr(tp, tb, torch.from_numpy(A[t]),
                            torch.from_numpy(tau[t]), torch.tensor(m[t]),
                            torch.tensor(eta[t]), None, ts)
            p, _, js = jqr(p, tuple(x[t] for x in jb), jnp.asarray(A[t]),
                           jnp.asarray(tau[t]), jnp.float32(m[t]),
                           jnp.float32(eta[t]), None, js)
            ref["q"].append(([np.asarray(x) for x in jax.tree.leaves(p)],
                             [a.numpy() for a in tree_flatten(
                                 packing.unpack_row(allow * 1.01 + 1e-7,
                                                    spec))[0]]))
        # LocalEngine on the server runs the mesh side repeats
        from repro_torch import topology
        from repro_torch.core.server import FederatedServer, ServerConfig
        from repro_torch.data import lm_batches, make_token_stream
        from repro_torch.fl.engine import ExecutionConfig

        local = {}
        for mixing, scan in SERVER_CASES:
            server, hist = _server(
                topology, FederatedServer, ServerConfig, lm_batches,
                make_token_stream,
                params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                ExecutionConfig(backend="einsum", scan=scan,
                                model_cfg=cfg), cfg, mesh=False)
            local[(mixing, scan)] = ([x.numpy() for x in tree_flatten(
                server.params)[0]], _columns(hist))
        for pr in procs:
            pr.wait(timeout=JOIN_S)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    logs = [pr.stdout.read().decode(errors="replace") for pr in procs]
    assert [pr.returncode for pr in procs] == [0] * WORLD, "\n".join(logs)
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(WORLD)]
    return types.SimpleNamespace(res=ranks[0]["res"], ref=ref, local=local,
                                 digests=[r["digest"] for r in ranks])


def tree_flatten_like(params, n):
    from repro_torch.core.pytree import tree_map
    return tree_map(lambda x: torch.empty((n,) + tuple(x.shape),
                                          dtype=x.dtype, device="meta"),
                    params)


def _leaves(run, key):
    return [x.numpy() for x in run.res[key]]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mixing", MIXINGS)
def test_schedule_matches_the_single_host_oracle(run, mesh, mixing):
    for t in range(K):
        for got, want in zip(_leaves(run, f"{mesh}/{mixing}/seq{t}"),
                             run.ref["seq"][t]):
            np.testing.assert_allclose(got, want, **ORACLE,
                                       err_msg=f"round {t}")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mixing", MIXINGS)
def test_scanned_equals_sequential_bitwise(run, mesh, mixing):
    seq = _leaves(run, f"{mesh}/{mixing}/scan")
    for t in range(K):
        _equal([x[t] for x in seq], _leaves(run, f"{mesh}/{mixing}/seq{t}"))
    _equal(_leaves(run, f"{mesh}/{mixing}/scan_final"),
           _leaves(run, f"{mesh}/{mixing}/seq{K - 1}"))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mixing", MIXINGS)
def test_dropped_clients_match_the_oracle(run, mesh, mixing):
    for got, want in zip(_leaves(run, f"{mesh}/{mixing}/active"),
                         run.ref["active"]):
        np.testing.assert_allclose(got, want, **ORACLE)
    _equal(_leaves(run, f"{mesh}/{mixing}/active_scan"),
           _leaves(run, f"{mesh}/{mixing}/active"))


@pytest.mark.parametrize("mixing", MIXINGS)
def test_one_pod_asymmetric_round_matches_the_oracle(run, mixing):
    """(1, 4, 1): one pod of four clients under an asymmetric A (the
    trajectory's 2-client clusters mix symmetrically)."""
    for got, want in zip(_leaves(run, f"1x4x1/{mixing}/pod"),
                         run.ref["pod"]):
        np.testing.assert_allclose(got, want, **ORACLE)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mixing", MIXINGS)
def test_all_ones_active_is_none_bitwise(run, mesh, mixing):
    _equal(_leaves(run, f"{mesh}/{mixing}/ones0"),
           _leaves(run, f"{mesh}/{mixing}/plain0"))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mixing", QMIX)
def test_quantized_schedule_matches_the_oracle(run, mesh, mixing):
    flips = total = 0
    for t in range(KQ):
        want, allow = run.ref["q"][t]
        for got, w, a in zip(_leaves(run, f"{mesh}/{mixing}/q{t}"), want,
                             allow):
            flips += _flips_allowed(got, w, a, ORACLE)
            total += got.size
    assert flips <= 1e-3 * total
    _equal(_leaves(run, f"{mesh}/{mixing}/qscan"),
           _leaves(run, f"{mesh}/{mixing}/q{KQ - 1}"))


@pytest.mark.parametrize("mesh", MESHES)
def test_every_rank_holds_the_same_params(run, mesh):
    keys = [k for k in run.digests[0] if k.startswith(mesh)]
    assert len(keys) == len(MIXINGS) * (K + 6 + (mesh == "1x4x1")) \
        + len(QMIX) * (KQ + 1)
    for d in run.digests[1:]:
        assert {k: d[k] for k in keys} == {k: run.digests[0][k]
                                           for k in keys}


@pytest.mark.parametrize("mixing,scan", SERVER_CASES)
def test_mesh_engine_history_matches_local_engine(run, mixing, scan):
    params, cols = run.local[(mixing, scan)]
    assert run.res[f"server/{mixing}/{scan}/hist"] == cols
    assert len(cols) == 3
    for got, want in zip(_leaves(run, f"server/{mixing}/{scan}"), params):
        np.testing.assert_allclose(got, want, **ORACLE)
    for d in run.digests[1:]:
        key = f"server/{mixing}/{scan}"
        assert d[key] == run.digests[0][key]


def _stand_in(shape, names=("pod", "data", "model")):
    return types.SimpleNamespace(shape=shape, mesh_dim_names=names,
                                 device_type="cpu")


@pytest.mark.parametrize("shape,names,want", [
    ((2, 2, 1), ("pod", "data", "model"), (("pod", "data"), 4, 1, 2)),
    ((1, 4, 1), ("pod", "data", "model"), (("pod", "data"), 4, 1, 4)),
    ((4, 2), ("data", "model"), (("data",), 4, 2, 4))])
def test_mesh_helpers(shape, names, want):
    from repro_torch.launch import mesh as M

    mesh = _stand_in(shape, names)
    assert (M.client_axes(mesh), M.n_clients_of(mesh),
            M.model_axis_size(mesh), M.data_axis_size(mesh)) == want


@pytest.mark.parametrize("what", ["model_axis", "zero", "prefill", "decode",
                                  "engine", "moe_expert", "sp"])
def test_what_13b_holds_raises(what, monkeypatch):
    """What the port once refused at a 'model' axis above 1 is placed and
    resolved now (the runs themselves: ``tests/test_torch_tp.py``,
    ``tests/test_torch_tp2.py``): MLA and the SSD split by whole heads,
    the SSD's single group and the cache it feeds stay whole, the engine
    resolves a hybrid mesh config, the expert rules split whole experts,
    and sequence parallelism takes the 'model' axis but refuses a
    sequence the group does not divide; ZeRO off 'ring' still raises, as
    the reference refuses it."""
    from repro_torch.configs import get_config
    from repro_torch.fl import distributed as D
    from repro_torch.fl.engine import ExecutionConfig, resolve_backend
    from repro_torch.models import sharding

    def reduced(name):
        return get_config(name).reduced(d_model=64, vocab=128)

    def layout(cfg, shape):
        return dict(zip(_leaf_paths(cfg),
                        D.param_layout(cfg, _stand_in(shape))))

    if what == "zero":
        with pytest.raises(ValueError, match="ring"):
            D.make_train_step(_cfg(get_config), _stand_in((2, 2, 1)),
                              mixing="fused", zero=True)
    elif what == "model_axis":
        got = layout(reduced("deepseek-v2-236b"), (2, 1, 2))
        assert got["decoder/layers/mla/wkv_b"] == (None, None, "model")
        assert got["decoder/layers/mla/wo"] == (None, "model", None)
        assert got["decoder/layers/mla/wkv_a"] == (None, None, None)
    elif what == "prefill":
        got = layout(reduced("mamba2-1.3b"), (1, 1, 2))
        assert got["decoder/layers/ssm/w_x"] == (None, None, "model")
        assert got["decoder/layers/ssm/w_B"] == (None, None, None)
    elif what == "decode":
        cfg = reduced("deepseek-v2-236b")
        monkeypatch.setattr(sharding, "model_rank", lambda: (0, 2))
        from repro_torch.models.model import Model
        cache = Model(cfg, device="cpu").init_cache(2, 16)
        assert tuple(cache["layers"]["ckv"].shape[-2:]) == \
            (16, cfg.kv_lora_rank)                   # whole latent ring
    elif what == "engine":
        assert resolve_backend(ExecutionConfig(
            mesh=_stand_in((1, 2, 2)), model_cfg=reduced("zamba2-2.7b"))) \
            == "einsum"
    elif what == "moe_expert":
        sharding.set_moe_sharding("expert")
        try:
            got = layout(reduced("phi3.5-moe-42b-a6.6b"), (1, 1, 2))
        finally:
            sharding.set_moe_sharding("tensor")
        assert got["decoder/layers/moe/gate"] == (None, "model", None, None)
    else:
        sharding.set_activation_sharding("model", sp_mlp=True)
        try:
            assert sharding.sp_mlp_axis() == "model"
            monkeypatch.setattr(sharding, "model_group", lambda: object())
            monkeypatch.setattr(sharding, "model_rank", lambda: (0, 2))
            assert sharding.seq_parallel(64)
            with pytest.raises(ValueError, match="S = 63"):
                sharding.seq_parallel(63)
        finally:
            sharding.set_activation_sharding(None)


def _leaf_paths(cfg):
    """``Model(cfg)``'s leaf paths in ``tree_flatten`` order (shapes
    only)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import sharding
    from repro_torch.models.model import Model

    with FakeTensorMode():
        return sharding._paths(Model(cfg, device="cpu").init(
            torch.Generator()))


@pytest.mark.parametrize("kw,match", [
    (dict(backend="einsum"), "model_cfg"),
    (dict(backend="aggregate", model_cfg=True), "mesh mixing"),
    (dict(backend="fused", record_mixed=True, model_cfg=True),
     "record_mixed"),
    (dict(backend="ring", quant="q", model_cfg=True), "one-pass")])
def test_mesh_backend_matrix_refuses(kw, match):
    from repro_torch.fl.engine import ExecutionConfig, resolve_backend
    from repro_torch.fl.packing import QuantSpec

    if kw.get("quant") == "q":
        kw = dict(kw, quant=QuantSpec())
    with pytest.raises(ValueError, match=match):
        resolve_backend(ExecutionConfig(mesh=_stand_in((2, 2, 1)), **kw))


def test_example_twin_runs_the_reference_plan():
    """``examples/mesh_fl_lm_torch.py --device cpu`` (four gloo ranks on
    (2, 2, 1)) trains and serves; its m(t) and d2s columns are the
    reference example's plan's."""
    from repro import topology as jtopology
    from repro.core.server import ServerConfig as JServerConfig
    from repro.fl.plan import RoundPlan as JRoundPlan

    rounds = 2
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, str(HERE.parents[1] / "examples"
                             / "mesh_fl_lm_torch.py"),
         "--device", "cpu", "--rounds", str(rounds)],
        env=env, capture_output=True, text=True, timeout=JOIN_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("round ")]
    plan = JRoundPlan.connectivity_aware(
        jtopology.make_spec("k_regular", n=N, c=2, k_range=(1, 2),
                            p_fail=0.0).build(),
        JServerConfig(T=2, t_max=rounds, phi_max=1.0, bound_kind="regular",
                      seed=0, eta=lambda t: 0.05))
    want = [f"round {t}: m(t)={plan.m_actual_t[t]}/{N}  d2s={plan.d2s_t[t]}"
            for t in range(rounds)]
    assert [ln.split("  loss=")[0] for ln in lines] == want
    assert "generated:" in proc.stdout


@pytest.mark.cuda
def test_every_schedule_on_a_one_card_nccl_mesh(tmp_path):
    """World size 1 on NCCL, mesh (1, 1, 1): every schedule's two rounds
    of a reduced stablelm equal ``LocalEngine``'s round function at
    n = 1 within the oracle tolerance, scanned == sequential bitwise,
    and 'fused' launches the aggregate kernel once a round."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.core.rounds import make_round_fn
    from repro_torch.fl import distributed as D
    from repro_torch.kernels.mixing import fused
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import Model

    cfg = _cfg(get_config)
    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    m = Model(cfg)
    params = m.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 1, T, B, S + 1),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    A, tau = torch.ones(2, 1, 1, device=dev), torch.ones(2, 1, device=dev)
    m_, eta = torch.ones(2, device=dev), torch.full((2,), 0.05, device=dev)
    local, want = make_round_fn(m.loss, "einsum"), params
    for t in range(2):
        want, _ = local(want, (toks[t][..., :-1], toks[t][..., 1:]), A[t],
                        tau[t], m_[t], eta[t])
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_debug_mesh((1, 1, 1))
        for mixing in MIXINGS:
            step = D.make_train_step(cfg, mesh, mixing=mixing)
            before, p = fused.aggregate_cuda.launches, params
            for t in range(2):
                p = step(p, toks[t], A[t], tau[t], m_[t], eta[t])
            assert fused.aggregate_cuda.launches - before == \
                (2 if mixing == "fused" else 0)
            final, _ = D.make_scanned_train_steps(cfg, mesh, 2,
                                                  mixing=mixing)(
                params, toks, A, tau, m_, eta)
            for a, b, c in zip(tree_leaves(p), tree_leaves(final),
                               tree_leaves(want)):
                assert torch.equal(a, b)
                np.testing.assert_allclose(a.cpu().numpy(),
                                           c.cpu().numpy(), **ORACLE)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(int(sys.argv[2]), Path(sys.argv[3]))
