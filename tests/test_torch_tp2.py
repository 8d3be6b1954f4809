"""Sequence parallelism, the expert-parallel MoE and the production-mesh
stand-in (``repro_torch.models.sharding``, ``models.moe``,
``launch.mesh``) against the reference run on the CPU.

Eight gloo ranks are spawned once for the module (this file run as a
script: ``python tests/test_torch_tp2.py worker RANK DIR``):

* The twin of ``tests/helpers/dist_equivalence.py``'s 'shardmap' and
  'shardmap+spmlp' steps: mesh (2, 2, 2), reduced stablelm at vocab 128,
  the helper's n, T, B, S, A, tau, m and eta, 'ring', against the
  reference's single-host ``make_round_fn``.
* The twin of ``sp_mlp_equivalence.py``: mesh (2, 4), reduced qwen2-7b
  (4 q / 1 kv heads: its attention runs whole, gathered and cut back to
  the rank's rows), the forward and ``torch.func.grad`` of the loss under
  ``set_activation_sharding('model', sp_mlp=True)`` on both routes of the
  sequence collectives ('collective': all-gather / reduce-scatter;
  'broadcast': the broadcasts and all-reduce that gloo runs on CUDA
  tensors), against the reference's single-host ``Model``.  A sequence
  the group does not divide raises ``ValueError``.
* Sequence parallelism through MLA, the SSD, the hybrid stack and the
  expert-parallel MoE at (2, 4): reduced mamba2 (with one and two SSD
  groups), zamba2, deepseek-v2 with a q latent and phi3.5-moe with
  ``moe_sharding='expert'`` -- the loss's
  gradient and the mesh prefill / decode steps against the reference's.
* The twin of ``moe_ep_equivalence.py``: reduced phi3.5-moe at (2, 4),
  ``moe_sharding='expert'`` (one whole expert a rank), forward and
  gradient against the reference's dense path; then the port's
  expert-parallel layer against the reference's ``_moe_expert_parallel``
  itself (run in a subprocess on 8 host devices: ``python
  tests/test_torch_tp2.py jax_ep DIR``) at 8 experts, 2 a rank, with a
  router that sends most tokens to expert 0, so that slots are dropped:
  the outputs and the dropped counts equal.  With only the global
  ``set_moe_sharding('expert')`` (the config at 'tensor') a rank holds
  whole experts and runs the drop-free path, as the reference's GSPMD
  does.
* ``make_production_mesh`` on the eight-rank world (4 a node), and
  ``production_shape`` on stand-in worlds (pure).

Tolerances: rounds against the reference ``rtol=2e-4, atol=2e-5`` (the
helper's); the forward under sequence parallelism ``2e-4`` and its
gradients ``rtol=1e-3, atol=1e-5`` (the SP-MLP helper's); serving
``2e-4`` (the serve helper's); the expert-parallel forward against the
dense path ``5e-3`` and its gradients ``rtol=1e-2, atol=1e-3`` (the EP
helper's), the same algorithm as the reference's ``rtol=2e-4,
atol=2e-5``.
"""

import dataclasses
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
WORLD, JOIN_S = 8, 240
N, T, B, S = 4, 2, 2, 16                # the dist helper's round
SB, SS = 2, 32                          # the SP / EP helpers' batch
SK = 24                                 # the serve helper's prompt
ORACLE = dict(rtol=2e-4, atol=2e-5)
FWD_TOL, GRAD_TOL = dict(rtol=2e-4, atol=2e-4), dict(rtol=1e-3, atol=1e-5)
SERVE_TOL = dict(rtol=2e-4, atol=2e-4)
EP_FWD, EP_GRAD = dict(rtol=5e-3, atol=5e-3), dict(rtol=1e-2, atol=1e-3)
ROUTES = ("collective", "broadcast")
SP_ZOO = ("mamba2-1.3b", "mamba2-g2", "zamba2-2.7b", "deepseek-lora",
          "phi3.5-ep")
EP_T, EP_E = 64, 8                      # the drop case: tokens, experts


def _cfg(get_config, name):
    """Reduced configs at vocab 128 (``mamba2-g2``: mamba2 with two SSD
    groups, whole on every rank at m = 4, each rank's heads reading their
    own group; ``deepseek-lora``: deepseek-v2 with a q latent of 32;
    ``phi3.5-ep``: phi3.5-moe, ragged, ``moe_sharding='expert'``;
    ``phi3.5-ep8``: that with 8 experts)."""
    if name == "mamba2-g2":
        return dataclasses.replace(
            get_config("mamba2-1.3b").reduced(vocab=128), ssm_groups=2)
    if name == "deepseek-lora":
        return dataclasses.replace(
            get_config("deepseek-v2-236b").reduced(vocab=128),
            q_lora_rank=32)
    if name.startswith("phi3.5-ep"):
        cfg = dataclasses.replace(
            get_config("phi3.5-moe-42b-a6.6b").reduced(vocab=128),
            moe_sharding="expert", moe_impl="ragged")
        return cfg if name == "phi3.5-ep" else dataclasses.replace(
            cfg, n_experts=EP_E)
    return get_config(name).reduced(vocab=128)


def _param_names():
    return ("stablelm-1.6b", "qwen2-7b") + SP_ZOO


# ---------------------------------------------------------------------------
# the ranks (this file run as a script)
# ---------------------------------------------------------------------------

def _worker(rank: int, out: Path) -> None:
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_flatten, tree_unflatten
    from repro_torch.fl import distributed as D
    from repro_torch.launch import mesh as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import sharding
    from repro_torch.models.model import Model

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=JOIN_S))
    inp = np.load(out / "inputs.npz")
    res = {}

    def params_of(name, cfg):
        _, treedef = tree_flatten(Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0)))
        n = len([k for k in inp.files
                 if k.startswith(f"{name}/p") and k[len(name) + 2:].isdigit()])
        return tree_unflatten(treedef, [torch.from_numpy(inp[f"{name}/p{i}"])
                                        for i in range(n)])

    def leaves(tree):
        return [x.detach().clone() for x in tree_flatten(tree)[0]]

    def sp_on():
        sharding.set_activation_sharding("model", sp_mlp=True)

    def sp_off():
        sharding.set_activation_sharding(None)

    plain_route = sharding.seq_route

    # (i) the 'shardmap' client step, plain and with the SP-MLP
    mesh = M.make_debug_mesh((2, 2, 2), device="cpu")
    cfg = _cfg(get_config, "stablelm-1.6b")
    local = D.shard_params(params_of("stablelm-1.6b", cfg), cfg, mesh)
    args = tuple(torch.from_numpy(inp[k])
                 for k in ("toks", "A", "tau", "m", "eta"))
    for name, sp in (("shardmap", False), ("shardmap+spmlp", True)):
        if sp:
            sp_on()
        try:
            step = D.make_train_step(cfg, mesh, mixing="ring",
                                     client_impl="shardmap")
            res[f"round/{name}"] = leaves(D.gather_params(step(local, *args),
                                                          cfg, mesh))
        finally:
            sp_off()

    # (ii) the SP-MLP helper's twin at (2, 4), both routes
    smesh = M.make_debug_mesh((2, 4), ("data", "model"), device="cpu")
    group = smesh.get_group("model")
    toks, tgt = (torch.from_numpy(inp[k]) for k in ("sp_toks", "sp_tgt"))
    qcfg = _cfg(get_config, "qwen2-7b")
    qmodel = Model(qcfg, device="cpu")
    qlocal = D.shard_params(params_of("qwen2-7b", qcfg), qcfg, smesh)
    for route in ROUTES:
        sharding.seq_route = lambda g, x, r=route: r
        sp_on()
        try:
            with sharding.model_parallel(group):
                logits = qmodel.forward(qlocal, toks)[0]
                grads = torch.func.grad(qmodel.loss)(qlocal, (toks, tgt))
        finally:
            sp_off()
            sharding.seq_route = plain_route
        res[f"sp/qwen2-7b/{route}/fwd"] = logits.detach().clone()
        res[f"sp/qwen2-7b/{route}/grad"] = leaves(
            D.gather_params(grads, qcfg, smesh))
    sp_on()
    try:
        with sharding.model_parallel(group):
            qmodel.forward(qlocal, toks[:, :30])
        res["sp/ragged_s"] = ""
    except ValueError as e:
        res["sp/ragged_s"] = str(e)
    finally:
        sp_off()

    # sequence parallelism through MLA, SSD, hybrid and the EP MoE
    for name in SP_ZOO:
        zcfg = _cfg(get_config, name)
        zmodel = Model(zcfg, device="cpu")
        zlocal = D.shard_params(params_of(name, zcfg), zcfg, smesh)
        sp_on()
        try:
            with sharding.model_parallel(group):
                grads = torch.func.grad(zmodel.loss)(zlocal, (toks, tgt))
            prefill = D.make_prefill_step(zcfg, smesh, ("data",), SK + 4)
            decode = D.make_decode_step(zcfg, smesh, ("data",))
            pre, cache = prefill(zlocal, toks[:, :SK])
            dec, _ = decode(zlocal, cache, toks[:, SK], SK)
        finally:
            sp_off()
        rows = D.batch_rows(smesh, ("data",), SB)
        res[f"sp/{name}/grad"] = leaves(D.gather_params(grads, zcfg, smesh))
        res[f"sp/{name}/serve/{rank}"] = (rows.start, rows.stop,
                                          pre.numpy(), dec.numpy())

    # (iii) the EP helper's twin: one whole expert a rank
    ecfg = _cfg(get_config, "phi3.5-ep")
    emodel = Model(ecfg, device="cpu")
    elocal = D.shard_params(params_of("phi3.5-ep", ecfg), ecfg, smesh)
    res["ep/gate_shape"] = tuple(
        elocal["decoder"]["layers"]["moe"]["gate"].shape)
    moe_mod.ep_stats_reset()
    with sharding.model_parallel(group):
        res["ep/fwd"] = emodel.forward(elocal, toks)[0]
        res["ep/calls"] = moe_mod.ep_stats()["calls"]
        res["ep/grad"] = leaves(D.gather_params(
            torch.func.grad(emodel.loss)(elocal, (toks, tgt)), ecfg, smesh))

    # whole experts a rank by the global rule alone (the config's
    # moe_sharding 'tensor'): the reference runs its drop-free path on
    # them under GSPMD, the port each rank's experts, summed
    gcfg = dataclasses.replace(ecfg, moe_sharding="tensor")
    gmodel = Model(gcfg, device="cpu")
    sharding.set_moe_sharding("expert")
    try:
        glocal = D.shard_params(params_of("phi3.5-ep", gcfg), gcfg, smesh)
        moe_mod.ep_stats_reset()
        with sharding.model_parallel(group):
            res["ep_global/fwd"] = gmodel.forward(glocal, toks)[0]
            res["ep_global/grad"] = leaves(D.gather_params(
                torch.func.grad(gmodel.loss)(glocal, (toks, tgt)), gcfg,
                smesh))
        res["ep_global/calls"] = moe_mod.ep_stats()["calls"]
        res["ep_global/gate_shape"] = tuple(
            glocal["decoder"]["layers"]["moe"]["gate"].shape)
    finally:
        sharding.set_moe_sharding("tensor")

    # the port's layer against the reference's _moe_expert_parallel,
    # slots dropped: 8 experts, 2 a rank
    dcfg = _cfg(get_config, "phi3.5-ep8")
    r = sharding.model_rank
    p = {k: torch.from_numpy(inp[f"ep8/{k}"])
         for k in ("router", "gate", "up", "down")}
    with sharding.model_parallel(group):
        me, m = r()
        e_loc = EP_E // m
        mine = {k: (v if k == "router" else v[me * e_loc:(me + 1) * e_loc])
                for k, v in p.items()}
        moe_mod.ep_stats_reset()
        x = torch.from_numpy(inp["ep8/x"])
        y, _ = moe_mod.moe_apply(dcfg, mine, x[None])
        res["ep8/out"] = y[0]
        res["ep8/stats"] = moe_mod.ep_stats()

    # (vi) the production mesh's stand-in on this world, 4 ranks a node
    for multi_pod in (False, True):
        pm = M.make_production_mesh(multi_pod=multi_pod, node=4,
                                    device="cpu")
        res[f"prod/{multi_pod}"] = (tuple(pm.shape), pm.mesh_dim_names,
                                    M.n_clients_of(pm),
                                    M.model_axis_size(pm))

    gathered = [None] * WORLD
    dist.all_gather_object(gathered, {k: v for k, v in res.items()
                                      if "/serve/" in k})
    if rank == 0:
        for g in gathered:
            res.update(g)
        torch.save(res, out / "rank0.pt")
    dist.barrier()
    dist.destroy_process_group()


def _jax_ep(out: Path) -> None:
    """The reference's ``_moe_expert_parallel`` on ``ep8/*`` over an
    8-device (2, 4) mesh, with the slots its capacity drops."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.launch.mesh import make_debug_mesh
    from repro.models import moe as jmoe

    inp = np.load(out / "inputs.npz")
    cfg = _cfg(get_config, "phi3.5-ep8")
    p = {k: jnp.asarray(inp[f"ep8/{k}"])
         for k in ("router", "gate", "up", "down")}
    x = jnp.asarray(inp["ep8/x"])
    mesh = make_debug_mesh((2, 4), ("data", "model"))
    with jax.set_mesh(mesh):
        y, _ = jax.jit(lambda p, x: jmoe._moe_expert_parallel(cfg, p, x))(
            p, x)
    # its dropped slots, from its own routing (the rank of a slot within
    # its expert in token order against the capacity)
    _, ids, _ = jmoe._route(cfg, p, x)
    ids = np.asarray(ids).reshape(-1)
    cap = max(int(2.0 * x.shape[0] * cfg.experts_per_token
                  / cfg.n_experts), 8)
    seen = np.zeros(cfg.n_experts, int)
    dropped = 0
    for e in ids:
        dropped += int(seen[e] >= cap)
        seen[e] += 1
    np.savez(out / "ep_ref.npz", out=np.asarray(y), dropped=dropped,
             cap=cap)


# ---------------------------------------------------------------------------
# the parent: inputs, the reference, one spawn for the module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.core import rounds as jrounds
    from repro.core.adjacency import block_diagonal, equal_neighbor_matrix
    from repro.core.graphs import k_regular_digraph
    from repro.models.model import Model as JModel

    out = tmp_path_factory.mktemp("tp2")
    rng = np.random.default_rng(0)
    inputs = {"toks": rng.integers(0, 128, (N, T, B, S + 1)).astype(np.int32)}
    blocks = [equal_neighbor_matrix(k_regular_digraph(2, 1, rng))
              for _ in range(2)]
    inputs.update(A=block_diagonal(blocks).astype(np.float32),
                  tau=np.asarray([1.0, 0.0, 1.0, 1.0], np.float32),
                  m=np.float32(3.0), eta=np.float32(0.05))
    inputs["sp_toks"] = rng.integers(0, 128, (SB, SS)).astype(np.int32)
    inputs["sp_tgt"] = rng.integers(0, 128, (SB, SS)).astype(np.int32)
    jms, jps = {}, {}
    for name in _param_names():
        jms[name] = JModel(_cfg(j_get_config, name))
        jps[name] = jms[name].init(jax.random.key(0))
        for i, x in enumerate(jax.tree.leaves(jps[name])):
            inputs[f"{name}/p{i}"] = np.asarray(x)
    # the drop case: expert 0's router column raised, so every token picks
    # it
    d = jms["phi3.5-ep"].cfg.d_model
    ff = jms["phi3.5-ep"].cfg.moe_d_ff
    router = (rng.standard_normal((d, EP_E)) / np.sqrt(d)).astype(np.float32)
    router[:, 0] += np.float32(0.05)
    inputs.update({
        "ep8/router": router,
        "ep8/gate": (rng.standard_normal((EP_E, d, ff)) / np.sqrt(d))
        .astype(np.float32),
        "ep8/up": (rng.standard_normal((EP_E, d, ff)) / np.sqrt(d))
        .astype(np.float32),
        "ep8/down": (rng.standard_normal((EP_E, ff, d)) / np.sqrt(ff))
        .astype(np.float32),
        # a common direction in every token: expert 0 is every token's
        # first choice, twice its capacity
        "ep8/x": (rng.standard_normal((EP_T, d)) + 0.5).astype(np.float32)})
    np.savez(out / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(HERE), "worker", str(r),
                               str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, str(HERE), "jax_ep", str(out)],
        env=dict(env, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT))
    try:
        ref = {}
        jm, jp = jms["stablelm-1.6b"], jps["stablelm-1.6b"]
        rnd = ((jnp.asarray(inputs["toks"][..., :-1]),
                jnp.asarray(inputs["toks"][..., 1:])),
               jnp.asarray(inputs["A"]), jnp.asarray(inputs["tau"]),
               jnp.float32(inputs["m"]), jnp.float32(inputs["eta"]))
        ref["round"] = [np.asarray(x) for x in jax.tree.leaves(
            jrounds.make_round_fn(jm.loss)(jp, *rnd)[0])]
        toks = jnp.asarray(inputs["sp_toks"])
        tgt = jnp.asarray(inputs["sp_tgt"])
        for name in ("qwen2-7b", "phi3.5-ep") + SP_ZOO:
            if f"{name}/grad" in ref:
                continue
            jm, jp = jms[name], jps[name]
            ref[f"{name}/fwd"] = np.asarray(jm.forward(jp, toks)[0])
            ref[f"{name}/grad"] = [np.asarray(x) for x in jax.tree.leaves(
                jax.grad(jm.loss)(jp, (toks, tgt)))]
            if name in SP_ZOO:
                lg, cache = jm.prefill(jp, toks[:, :SK], max_len=SK + 4)
                dec, _ = jm.decode(jp, cache, toks[:, SK],
                                   jnp.asarray(SK, jnp.int32))
                ref[f"{name}/serve"] = (np.asarray(lg), np.asarray(dec))
        for pr in procs:
            pr.wait(timeout=JOIN_S)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    logs = [pr.stdout.read().decode(errors="replace") for pr in procs]
    assert [pr.returncode for pr in procs] == [0] * (WORLD + 1), \
        "\n".join(logs)
    res = torch.load(out / "rank0.pt", weights_only=False)
    ep = dict(np.load(out / "ep_ref.npz"))
    return types.SimpleNamespace(res=res, ref=ref, ep=ep)


def _close(got, want, tol, msg=""):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, **tol, err_msg=msg)


# ---------------------------------------------------------------------------
# (i) the 'shardmap' client step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["shardmap", "shardmap+spmlp"])
def test_shardmap_round_matches_the_reference(run, name):
    _close(run.res[f"round/{name}"], run.ref["round"], ORACLE, name)


# ---------------------------------------------------------------------------
# (ii) the SP-MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
def test_sp_mlp_forward_and_grads_match_the_reference(run, route):
    np.testing.assert_allclose(run.res[f"sp/qwen2-7b/{route}/fwd"].numpy(),
                               run.ref["qwen2-7b/fwd"], **FWD_TOL)
    _close(run.res[f"sp/qwen2-7b/{route}/grad"], run.ref["qwen2-7b/grad"],
           GRAD_TOL, route)


def test_sequence_parallelism_refuses_a_ragged_sequence(run):
    msg = run.res["sp/ragged_s"]
    assert "S = 30" in msg and "4" in msg


@pytest.mark.parametrize("name", SP_ZOO)
def test_sequence_parallel_grads_match_the_reference(run, name):
    _close(run.res[f"sp/{name}/grad"], run.ref[f"{name}/grad"], GRAD_TOL,
           name)


@pytest.mark.parametrize("name", SP_ZOO)
def test_sequence_parallel_serve_steps_match_the_reference(run, name):
    want_pre, want_dec = run.ref[f"{name}/serve"]
    covered = np.zeros(SB, bool)
    for r in range(WORLD):
        start, stop, pre, dec = run.res[f"sp/{name}/serve/{r}"]
        np.testing.assert_allclose(pre, want_pre[start:stop], **SERVE_TOL)
        np.testing.assert_allclose(dec, want_dec[start:stop], **SERVE_TOL)
        covered[start:stop] = True
    assert covered.all()


# ---------------------------------------------------------------------------
# (iii) the expert-parallel MoE
# ---------------------------------------------------------------------------

def test_expert_parallel_matches_the_dense_path(run):
    assert run.res["ep/gate_shape"][1] == 1           # one expert a rank
    assert run.res["ep/calls"] == 2                   # both layers
    np.testing.assert_allclose(run.res["ep/fwd"].numpy(),
                               run.ref["phi3.5-ep/fwd"], **EP_FWD)
    _close(run.res["ep/grad"], run.ref["phi3.5-ep/grad"], EP_GRAD)


def test_global_expert_rule_runs_the_drop_free_path(run):
    """``set_moe_sharding('expert')`` with a config left at 'tensor': a
    rank holds one whole expert, drops nothing (the capacity path never
    ran) and matches the reference's single-host forward and gradient."""
    assert run.res["ep_global/gate_shape"][1] == 1
    assert run.res["ep_global/calls"] == 0
    np.testing.assert_allclose(run.res["ep_global/fwd"].numpy(),
                               run.ref["phi3.5-ep/fwd"], **FWD_TOL)
    _close(run.res["ep_global/grad"], run.ref["phi3.5-ep/grad"], GRAD_TOL)


def test_expert_parallel_equals_the_references_and_drops_the_same(run):
    stats = run.res["ep8/stats"]
    assert stats["calls"] == 1 and stats["slots"] == EP_T * 2
    assert stats["dropped"] == int(run.ep["dropped"]) > 0
    np.testing.assert_allclose(run.res["ep8/out"].numpy(), run.ep["out"],
                               **ORACLE)


# ---------------------------------------------------------------------------
# (vi) the production mesh's stand-in
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod,want", [
    (False, ((2, 4), ("data", "model"), 2, 4)),
    (True, ((2, 1, 4), ("pod", "data", "model"), 2, 4))])
def test_production_mesh_on_eight_ranks(run, multi_pod, want):
    assert run.res[f"prod/{multi_pod}"] == want


@pytest.mark.parametrize("world,node,multi_pod,want", [
    (1, 1, False, (1, 1)),
    (4, 4, False, (1, 4)),
    (8, 4, False, (2, 4)),
    (8, 4, True, (2, 1, 4)),
    (256, 16, False, (16, 16)),          # the reference's single pod
    (512, 16, True, (2, 16, 16)),        # and its two pods
    (64, 32, False, (4, 16))])
def test_production_shape(world, node, multi_pod, want):
    from repro_torch.launch.mesh import production_shape

    shape, axes = production_shape(world, node, multi_pod)
    assert shape == want
    assert axes == (("pod",) if multi_pod else ()) + ("data", "model")


@pytest.mark.parametrize("world,node,multi_pod", [
    (6, 4, False), (4, 4, True), (24, 32, False), (0, 4, False)])
def test_production_shape_refuses_a_world_it_cannot_factor(world, node,
                                                           multi_pod):
    from repro_torch.launch.mesh import production_shape

    with pytest.raises(ValueError, match="production layout"):
        production_shape(world, node, multi_pod)


if __name__ == "__main__" and len(sys.argv) == 4 \
        and sys.argv[1] == "worker":
    sys.path.insert(0, str(SRC))
    _worker(int(sys.argv[2]), Path(sys.argv[3]))
elif __name__ == "__main__" and len(sys.argv) == 3 \
        and sys.argv[1] == "jax_ep":
    sys.path.insert(0, str(SRC))
    _jax_ep(Path(sys.argv[2]))
