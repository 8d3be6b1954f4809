"""Tensor parallelism inside a client (``repro_torch.models.sharding``,
the 'model' mesh axis of ``repro_torch.fl.distributed``) against the
reference run on the CPU.

* The specs: ``param_specs`` of all ten archs' reduced params at a
  'model' axis of 1, 2, 4 and 8 under both MoE rules, ``cache_specs`` of
  every arch's decode cache, ``zero_specs`` of stablelm's params, each
  equal to the reference's ``PartitionSpec`` as a tuple (pure functions).
* The twin of ``tests/helpers/dist_equivalence.py``: eight gloo ranks
  spawned once for the module (this file run as a script: ``python
  tests/test_torch_tp.py worker RANK DIR``) on mesh (2, 2, 2), reduced
  stablelm at vocab 128 with the helper's n, T, B, S, A, tau, m and eta.
  Every schedule for two composed rounds (the second on fresh inputs)
  against the reference's ``make_round_fn``, scanned == sequential
  bitwise, ``zero`` on 'ring', int8 on 'fused' / 'fused_rs', reduced
  phi3.5-moe (tensor-parallel experts, dense and ragged) on 'fused', and
  ``MeshEngine`` against ``LocalEngine``.
* MLA, SSD and the hybrid stack: one round on every schedule at mesh
  (2, 2, 2) for reduced mamba2 (one SSD group, and two: one a rank),
  zamba2 and deepseek-v2 (with and
  without ``q_lora_rank``; tensor-parallel and expert-parallel experts)
  against the reference's ``make_round_fn``; reduced phi3.5-moe with
  ``moe_sharding='expert'`` (two whole experts a rank) on 'fused'.
* The twin of ``serve_equivalence.py``: mesh (2, 4) on the same ranks,
  ``make_prefill_step`` / ``make_decode_step`` against the reference's
  ``Model.prefill`` / ``decode`` for qwen2-7b, stablelm, phi3.5-moe, a
  qwen3 whose 8 / 4 heads split into whole heads at m = 4 (the reduced
  qwen2-7b and phi3.5 keep one kv head, so their attention is
  replicated), musicgen with its audio prefix, and the helper's mamba2
  and deepseek-v2, plus zamba2 (their caches: the rank's SSD heads and
  conv channels, the whole MLA latent ring).
* Gradients: on each client's two ranks, the loss and its
  ``torch.func.grad`` with remat off and on, gathered, against the
  one-rank port and the reference's ``jax.grad``.

Tolerances: rounds and gradients against the reference ``rtol=2e-4,
atol=2e-5`` (the helper's), serving ``rtol=2e-4, atol=2e-4`` (the serve
helper's).  Quantized rounds: a rank quantizes its own shards, whose
scale blocks are not the whole tree's, so each value may differ from the
reference's by what rounding in either layout allows: one grid step of
each layout's block a round (its own and the previous round's error
feedback), weighted by the combine row and summed over the rounds.
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
MESH, SERVE_MESH = (2, 2, 2), (2, 4)
MIXINGS = ("ring", "gather", "einsum", "fused", "fused_rs")
QMIX = ("fused", "fused_rs")
SERVER_CASES = (("fused", False), ("ring", True))
N, T, B, S, ROUNDS = 4, 2, 2, 16, 2
SB, SK = 2, 24                       # the serve helper's batch and prompt
ORACLE = dict(rtol=2e-4, atol=2e-5)
SERVE_TOL = dict(rtol=2e-4, atol=2e-4)
WORLD, JOIN_S = 8, 240
ARCHS = ("qwen3-32b", "musicgen-large", "mamba2-1.3b", "internvl2-1b",
         "zamba2-2.7b", "deepseek-v2-236b", "phi3.5-moe-42b-a6.6b",
         "qwen1.5-4b", "qwen2-7b", "stablelm-1.6b")
SERVE = ("qwen2-7b", "stablelm-1.6b", "phi3.5-moe-42b-a6.6b", "qwen3-gqa",
         "musicgen-large", "mamba2-1.3b", "deepseek-v2-236b", "zamba2-2.7b")
TRAIN, MOE = "stablelm-1.6b", "phi3.5-moe-42b-a6.6b"
# MLA, SSD, hybrid, expert-parallel experts: one round on every schedule
ZOO_TRAIN = ("mamba2-1.3b", "mamba2-g2", "zamba2-2.7b", "deepseek-v2-236b",
             "deepseek-v2-236b+ep", "deepseek-lora", "deepseek-lora+ep")


def _cfg(get_config, name):
    """The reduced configs at vocab 128 (``qwen3-gqa``: qwen3-32b with 8
    q / 4 kv heads; ``deepseek-lora``: deepseek-v2 with a q latent of 32,
    the full config's ``wq_a -> q_norm -> wq_b`` path; ``mamba2-g2``:
    mamba2 with two SSD groups, split into one a rank at m = 2; a
    ``+ep`` suffix: ``moe_sharding='expert'``)."""
    base, _, ep = name.partition("+")
    if base == "qwen3-gqa":
        cfg = dataclasses.replace(
            get_config("qwen3-32b").reduced(vocab=128), n_heads=8,
            n_kv_heads=4)
    elif base == "mamba2-g2":
        cfg = dataclasses.replace(
            get_config("mamba2-1.3b").reduced(vocab=128), ssm_groups=2)
    elif base == "deepseek-lora":
        cfg = dataclasses.replace(
            get_config("deepseek-v2-236b").reduced(vocab=128),
            q_lora_rank=32)
    else:
        cfg = get_config(base).reduced(vocab=128)
    return dataclasses.replace(cfg, moe_sharding="expert") if ep else cfg


def _quant(QuantSpec):
    return QuantSpec(storage="int8", block=128)


def _prompt_len(cfg):
    """Prompt positions: the tokens and an audio / vlm prefix."""
    return SK + (cfg.frontend_len if cfg.frontend else 0)


# ---------------------------------------------------------------------------
# the ranks (this file run as a script)
# ---------------------------------------------------------------------------

def _worker(rank: int, out: Path) -> None:
    import torch.distributed as dist

    from repro_torch import topology
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_flatten, tree_map, \
        tree_unflatten
    from repro_torch.core.server import FederatedServer, ServerConfig
    from repro_torch.data import lm_batches, make_token_stream
    from repro_torch.fl import distributed as D
    from repro_torch.fl.engine import ExecutionConfig
    from repro_torch.fl.packing import QuantSpec
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import sharding
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.attention import local_heads
    from repro_torch.models.model import Model

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=JOIN_S))
    inp = np.load(out / "inputs.npz")
    res, digest = {}, {}

    def params_of(name, cfg):
        name = name.partition("+")[0]
        _, treedef = tree_flatten(Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0)))
        n = len([k for k in inp.files
                 if k.startswith(f"{name}/p") and k[len(name) + 2:].isdigit()])
        return tree_unflatten(treedef, [torch.from_numpy(inp[f"{name}/p{i}"])
                                        for i in range(n)])

    def keep(key, tree):
        leaves = [x.detach().clone() for x in tree_flatten(tree)[0]]
        digest[key] = [hashlib.sha1(x.numpy().tobytes()).hexdigest()
                       for x in leaves]
        if rank == 0:
            res[key] = leaves

    def rnd(t):
        return tuple(torch.from_numpy(inp[f"{k}{t}"])
                     for k in ("toks", "A", "tau", "m", "eta"))

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in
                   zip(tree_flatten(a)[0], tree_flatten(b)[0]))

    mesh = make_debug_mesh(MESH, device="cpu")
    cfg = _cfg(get_config, TRAIN)
    params = params_of(TRAIN, cfg)
    local = D.shard_params(params, cfg, mesh)
    stacked = [torch.stack(xs) for xs in zip(*(rnd(t) for t in
                                               range(ROUNDS)))]
    for mixing in MIXINGS:
        step = D.make_train_step(cfg, mesh, mixing=mixing)
        p, seq = local, []
        for t in range(ROUNDS):
            p = step(p, *rnd(t))
            seq.append(p)
            keep(f"{mixing}/r{t}", D.gather_params(p, cfg, mesh))
        final, pseq = D.make_scanned_train_steps(cfg, mesh, ROUNDS,
                                                 mixing=mixing)(local,
                                                                *stacked)
        res[f"{mixing}/scan_bitwise"] = equal(final, p) and all(
            equal(tree_map(lambda x: x[t], pseq), seq[t])
            for t in range(ROUNDS))

    # ZeRO on 'ring': the global copy split over 'data' too
    zlocal = D.shard_params(params, cfg, mesh, zero=True)
    res["zero/numel"] = (sum(x.numel() for x in tree_flatten(zlocal)[0]),
                         sum(x.numel() for x in tree_flatten(local)[0]))
    zstep = D.make_train_step(cfg, mesh, mixing="ring", zero=True)
    p = zlocal
    for t in range(ROUNDS):
        p = zstep(p, *rnd(t))
        keep(f"zero/r{t}", D.gather_params(p, cfg, mesh, zero=True))

    q = _quant(QuantSpec)
    for mixing in QMIX:
        qstep = D.make_train_step(cfg, mesh, mixing=mixing, quant=q)
        p, qs = local, D.init_rank_quant_state(local, q, mesh, mixing)
        for t in range(ROUNDS):
            p, qs = qstep(p, *rnd(t), qstate=qs)
            keep(f"q/{mixing}/r{t}", D.gather_params(p, cfg, mesh))
        final = D.make_scanned_train_steps(cfg, mesh, ROUNDS, mixing=mixing,
                                           quant=q)(
            local, *stacked,
            qstate=D.init_rank_quant_state(local, q, mesh, mixing))[0]
        res[f"q/{mixing}/scan_bitwise"] = equal(final, p)

    # phi3.5-moe: tensor-parallel experts, the dense oracle and ragged
    mcfg = _cfg(get_config, MOE)
    mparams = params_of(MOE, mcfg)
    mlocal = D.shard_params(mparams, mcfg, mesh)
    for impl in ("dense", "ragged"):
        c = dataclasses.replace(mcfg, moe_impl=impl)
        keep(f"moe/{impl}", D.gather_params(
            D.make_train_step(c, mesh, mixing="fused")(mlocal, *rnd(0)),
            c, mesh))
    group = mesh.get_group("model")
    # expert-parallel experts: two whole experts a rank
    ecfg = dataclasses.replace(mcfg, moe_sharding="expert")
    elocal = D.shard_params(mparams, ecfg, mesh)
    res["moe/expert_shapes"] = (
        tuple(elocal["decoder"]["layers"]["moe"]["gate"].shape),
        tuple(mlocal["decoder"]["layers"]["moe"]["gate"].shape))
    keep("moe/expert", D.gather_params(
        D.make_train_step(ecfg, mesh, mixing="fused")(elocal, *rnd(0)),
        ecfg, mesh))

    # MLA, SSD, hybrid: one round on every schedule
    for name in ZOO_TRAIN:
        zcfg = _cfg(get_config, name)
        zlocal = D.shard_params(params_of(name, zcfg), zcfg, mesh)
        for mixing in MIXINGS:
            keep(f"zoo/{name}/{mixing}", D.gather_params(
                D.make_train_step(zcfg, mesh, mixing=mixing)(zlocal,
                                                             *rnd(0)),
                zcfg, mesh))

    # the loss and its gradient on the client's two ranks, remat off / on
    batch = (torch.from_numpy(inp["toks0"])[0, 0, :, :-1],
             torch.from_numpy(inp["toks0"])[0, 0, :, 1:])
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat, loss_chunk=8)
        model = Model(c, device="cpu")
        with sharding.model_parallel(group):
            loss = model.loss(local, batch)
            grads = torch.func.grad(model.loss)(local, batch)
        res[f"grad/{remat}/loss"] = (float(loss),
                                     float(model.loss(params, batch)))
        keep(f"grad/{remat}", D.gather_params(grads, c, mesh))
        keep(f"grad/{remat}/one_rank",
             torch.func.grad(model.loss)(params, batch))

    # MeshEngine at (2, 2, 2) against LocalEngine (in the parent)
    for mixing, scan in SERVER_CASES:
        server, hist = _server(
            topology, FederatedServer, ServerConfig, lm_batches,
            make_token_stream, params,
            ExecutionConfig(backend=mixing, scan=scan, mesh=mesh,
                            model_cfg=cfg), cfg, mesh=True)
        keep(f"server/{mixing}/{scan}", server.params)
        res[f"server/{mixing}/{scan}/hist"] = _columns(hist)

    # serving on (2, 4): the batch over 'data', the weights over 'model'
    smesh = make_debug_mesh(SERVE_MESH, device="cpu")
    for name in SERVE:
        scfg = _cfg(get_config, name)
        slocal = D.shard_params(params_of(name, scfg), scfg, smesh)
        P = _prompt_len(scfg)
        prefill = D.make_prefill_step(scfg, smesh, ("data",), P + 4)
        decode = D.make_decode_step(scfg, smesh, ("data",))
        toks = torch.from_numpy(inp[f"{name}/toks"])
        prefix = (torch.from_numpy(inp[f"{name}/prefix"])
                  if f"{name}/prefix" in inp.files else None)
        logits, cache = prefill(slocal, toks, prefix)
        with sharding.model_parallel(smesh.get_group("model")):
            heads = local_heads(scfg)[1]
            ssd = ssm_mod.local_sizes(scfg)
        lc = cache["layers"]
        if "k" in lc:
            res[f"serve/{name}/cache_heads"] = (lc["k"].shape[3], heads)
        elif "state" in lc:
            res[f"serve/{name}/cache_heads"] = (
                (lc["state"].shape[2], lc["conv"].shape[-1]), ssd)
        else:
            res[f"serve/{name}/cache_heads"] = (
                tuple(lc["ckv"].shape[2:]), (P + 4, scfg.kv_lora_rank))
        dec, _ = decode(slocal, cache, torch.from_numpy(
            inp[f"{name}/next"]), P)
        rows = D.batch_rows(smesh, ("data",), SB)
        res[f"serve/{name}/{rank}"] = (rows.start, rows.stop,
                                       logits.numpy(), dec.numpy())
        keep(f"serve/{name}/rank{rank}", (logits, dec))

    res["digest"] = digest
    gathered = [None] * WORLD
    dist.all_gather_object(gathered, {k: v for k, v in res.items()
                                      if k.startswith("serve/")})
    if rank == 0:
        for r in gathered:
            res.update(r)
        torch.save(res, out / "rank0.pt")
    torch.save({"digest": digest}, out / f"digest{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _server(topology, FederatedServer, ServerConfig, lm_batches,
            make_token_stream, params, execution, cfg, mesh):
    """Algorithm 1 on ``k_regular(n=4, c=2, k_range=(1, 2))`` for two
    rounds, token batches from ``make_token_stream`` / ``lm_batches``
    (the mesh takes (n, T, B, S+1) arrays, ``LocalEngine`` the (x, y)
    pair)."""
    network = topology.make_spec("k_regular", n=N, c=2, k_range=(1, 2),
                                 p_fail=0.1).build()
    scfg = ServerConfig(T=T, t_max=ROUNDS, phi_max=1.0,
                        bound_kind="regular", seed=0,
                        eta=lambda t: 0.05 / (1 + 0.5 * t))
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
# the parent: inputs, the reference, one spawn for the module
# ---------------------------------------------------------------------------

def _rounds(rng):
    """The helper's round (2 pods of 2 clients, 1-regular digraphs,
    tau [1, 0, 1, 1], m 3, eta 0.05), then a second on fresh inputs."""
    from repro.core.adjacency import block_diagonal, equal_neighbor_matrix
    from repro.core.graphs import k_regular_digraph

    out = {}
    for t, (tau, eta) in enumerate((([1, 0, 1, 1], 0.05),
                                    ([1, 1, 0, 1], 0.04))):
        out[f"toks{t}"] = rng.integers(0, 128, size=(N, T, B, S + 1)) \
            .astype(np.int32)
        blocks = [equal_neighbor_matrix(k_regular_digraph(2, 1, rng))
                  for _ in range(2)]
        out[f"A{t}"] = block_diagonal(blocks).astype(np.float32)
        out[f"tau{t}"] = np.asarray(tau, np.float32)
        out[f"m{t}"] = np.float32(sum(tau))
        out[f"eta{t}"] = np.float32(eta)
    return out


def _shard_steps(deltas, spec_of, pack_kw, q, msize, w):
    """``w @`` one grid step of every value, in the layout a rank of each
    'model' index quantizes (its shards of ``deltas``, leading client
    axis), gathered to the whole tree's leaves (numpy)."""
    from repro_torch.core.pytree import tree_flatten, tree_unflatten
    from repro_torch.fl import packing
    from repro_torch.models import sharding

    parts = []
    for r in range(msize):
        local = tree_unflatten(tree_flatten(deltas)[1], [
            sharding.local_shard(x, (None,) + s, r, msize)
            for x, s in zip(tree_flatten(deltas)[0], spec_of)])
        spec = packing.pack_spec(local, quant=q, **pack_kw)
        steps = []
        for b in packing.pack(local, spec):
            st = (b.reshape(N, -1, q.block).abs().amax(2) / q.qmax) \
                .repeat_interleave(q.block, 1)
            steps.append(w @ st)
        parts.append(tree_flatten(packing.unpack_row(tuple(steps),
                                                     spec))[0])
    out = []
    for i, s in enumerate(spec_of):
        if "model" in s:
            out.append(torch.cat([p[i] for p in parts],
                                 s.index("model")).numpy())
        else:
            out.append(parts[0][i].numpy())
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.core import rounds as jrounds
    from repro.fl import packing as jpacking
    from repro.models.model import Model as JModel
    from repro_torch import topology
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_flatten
    from repro_torch.core.rounds import client_deltas
    from repro_torch.core.server import FederatedServer, ServerConfig
    from repro_torch.data import lm_batches, make_token_stream
    from repro_torch.fl.engine import ExecutionConfig
    from repro_torch.fl.packing import QuantSpec
    from repro_torch.kernels.mixing.ops import combine_weights
    from repro_torch.models import sharding
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import Model

    out = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    inputs = _rounds(rng)
    jps, jms = {}, {}
    for name in (TRAIN, MOE) + SERVE + ZOO_TRAIN:
        name = name.partition("+")[0]
        if name in jps:
            continue
        jcfg, cfg = _cfg(j_get_config, name), _cfg(get_config, name)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
        jms[name] = JModel(jcfg)
        jps[name] = jms[name].init(jax.random.key(0))
        for i, x in enumerate(jax.tree.leaves(jps[name])):
            inputs[f"{name}/p{i}"] = np.asarray(x)
    for name in SERVE:
        inputs[f"{name}/toks"] = rng.integers(0, 128, (SB, SK)) \
            .astype(np.int32)
        inputs[f"{name}/next"] = rng.integers(0, 128, (SB,)) \
            .astype(np.int32)
        c = jms[name].cfg
        if c.frontend:
            inputs[f"{name}/prefix"] = rng.standard_normal(
                (SB, c.frontend_len, c.frontend_dim)).astype(np.float32)
    np.savez(out / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(HERE), "worker", str(r),
                               str(out)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        ref = {}

        def rb(t):
            return ((jnp.asarray(inputs[f"toks{t}"][..., :-1]),
                     jnp.asarray(inputs[f"toks{t}"][..., 1:])),
                    jnp.asarray(inputs[f"A{t}"]),
                    jnp.asarray(inputs[f"tau{t}"]),
                    jnp.float32(inputs[f"m{t}"]),
                    jnp.float32(inputs[f"eta{t}"]))

        jm, jp = jms[TRAIN], jps[TRAIN]
        jround = jrounds.make_round_fn(jm.loss)
        p = jp
        for t in range(ROUNDS):
            p, _ = jround(p, *rb(t))
            ref[f"r{t}"] = [np.asarray(x) for x in jax.tree.leaves(p)]
        mround = jrounds.make_round_fn(jms[MOE].loss)
        ref["moe"] = [np.asarray(x) for x in
                      jax.tree.leaves(mround(jps[MOE], *rb(0))[0])]
        for name in ZOO_TRAIN:          # '+ep' reads its base's round
            if "+" not in name:
                zround = jrounds.make_round_fn(jms[name].loss)
                ref[f"zoo/{name}"] = [np.asarray(x) for x in jax.tree.leaves(
                    zround(jps[name], *rb(0))[0])]
        tb = (jnp.asarray(inputs["toks0"][0, 0, :, :-1]),
              jnp.asarray(inputs["toks0"][0, 0, :, 1:]))
        for remat in (False, True):
            jl = JModel(dataclasses.replace(jm.cfg, remat=remat,
                                            loss_chunk=8))
            ref[f"grad/{remat}"] = [np.asarray(x) for x in jax.tree.leaves(
                jax.grad(jl.loss)(jp, tb))]
            ref[f"grad/{remat}/loss"] = float(jl.loss(jp, tb))

        # the quantized reference, and each value's allowance: one grid
        # step of the whole tree's blocks and of a rank's shard blocks,
        # this round's and the last's, weighted by the combine row
        jq, q = _quant(jpacking.QuantSpec), _quant(QuantSpec)
        jqr = jrounds.make_round_fn(jm.loss, quant=jq)
        jspec = jpacking.pack_spec(jax.tree.map(
            lambda x: jax.ShapeDtypeStruct((N,) + x.shape, x.dtype), jp),
            quant=jq)
        cfg = _cfg(get_config, TRAIN)
        tm = Model(cfg, device="cpu")
        place = sharding.spec_leaves(sharding.placement_specs(
            params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), cfg,
            MESH[-1]))
        for mixing in QMIX:
            kw = dict(shards=MESH[1]) if mixing == "fused_rs" else {}
            js = jpacking.init_quant_state(jspec, N)
            p, tp = jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                          "cpu")
            allow, last, ref[f"q/{mixing}"] = None, None, []
            for t in range(ROUNDS):
                tb_t = (torch.from_numpy(inputs[f"toks{t}"][..., :-1]),
                        torch.from_numpy(inputs[f"toks{t}"][..., 1:]))
                d = client_deltas(tm.loss, tp, tb_t,
                                  torch.tensor(inputs[f"eta{t}"]))
                w = combine_weights(torch.from_numpy(inputs[f"A{t}"]),
                                    torch.from_numpy(inputs[f"tau{t}"]),
                                    torch.tensor(inputs[f"m{t}"])).abs()
                steps = [a + b for a, b in zip(
                    _shard_steps(d, place, kw, q, MESH[-1], w),
                    _shard_steps(d, [(None,) * len(s) for s in place], {},
                                 q, 1, w))]
                now = [s + (0 if last is None else lst)
                       for s, lst in zip(steps, last or steps)]
                allow = now if allow is None else [
                    a + b for a, b in zip(allow, now)]
                last = steps
                p, _, js = jqr(p, *rb(t), None, js)
                tp = params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
                ref[f"q/{mixing}"].append(
                    ([np.asarray(x) for x in jax.tree.leaves(p)],
                     [a * 1.01 + 1e-7 for a in allow]))

        for name in SERVE:
            toks = jnp.asarray(inputs[f"{name}/toks"])
            prefix = inputs.get(f"{name}/prefix")
            P = _prompt_len(jms[name].cfg)
            logits, cache = jms[name].prefill(
                jps[name], toks,
                None if prefix is None else jnp.asarray(prefix),
                max_len=P + 4)
            dec, _ = jms[name].decode(jps[name], cache,
                                      jnp.asarray(inputs[f"{name}/next"]),
                                      jnp.asarray(P, jnp.int32))
            ref[f"serve/{name}"] = (np.asarray(logits), np.asarray(dec))

        # LocalEngine runs the MeshEngine cases
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
    res = torch.load(out / "rank0.pt", weights_only=False)
    digests = [torch.load(out / f"digest{r}.pt")["digest"]
               for r in range(WORLD)]
    return types.SimpleNamespace(res=res, ref=ref, local=local,
                                 digests=digests)


def _leaves(run, key):
    return [x.numpy() for x in run.res[key]]


def _close(got, want, tol, msg=""):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **tol, err_msg=msg)


# ---------------------------------------------------------------------------
# the specs
# ---------------------------------------------------------------------------

_SHAPES = {}


def _both_params(name):
    """(reference param shapes, the port's fake params) of ``name``'s
    reduced config."""
    if name not in _SHAPES:
        import jax
        from torch._subclasses.fake_tensor import FakeTensorMode

        from repro.configs import get_config as j_get_config
        from repro.models.model import Model as JModel
        from repro_torch.configs import get_config
        from repro_torch.models.model import Model

        jcfg, cfg = j_get_config(name).reduced(), get_config(name).reduced()
        jshapes = jax.eval_shape(JModel(jcfg).init, jax.random.key(0))
        with FakeTensorMode():
            tp = Model(cfg, device="cpu").init(torch.Generator())
        _SHAPES[name] = (jcfg, cfg, jshapes, tp)
    return _SHAPES[name]


def _ref_specs(tree):
    import jax
    from jax.sharding import PartitionSpec as P

    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


@pytest.mark.parametrize("moe_sharding", ["tensor", "expert"])
@pytest.mark.parametrize("msize", [1, 2, 4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, msize, moe_sharding):
    from repro.models import sharding as jsharding
    from repro_torch.models import sharding

    _, _, jshapes, tp = _both_params(arch)
    jsharding.set_moe_sharding(moe_sharding)
    sharding.set_moe_sharding(moe_sharding)
    try:
        want = _ref_specs(jsharding.param_specs(jshapes, msize))
        got = sharding.spec_leaves(sharding.param_specs(tp, msize))
        want_p = _ref_specs(jsharding.param_specs(
            jshapes, msize, prefix=(("pod", "data"),)))
        got_p = sharding.spec_leaves(sharding.param_specs(
            tp, msize, prefix=(("pod", "data"),)))
    finally:
        jsharding.set_moe_sharding("tensor")
        sharding.set_moe_sharding("tensor")
    assert got == want
    assert got_p == want_p
    assert any("model" in s for s in got)


@pytest.mark.parametrize("msize", [1, 2, 4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, msize):
    import jax

    from repro.models import sharding as jsharding
    from repro.models.model import Model as JModel
    from repro_torch.models import sharding
    from repro_torch.models.model import Model

    jcfg, cfg, _, _ = _both_params(arch)
    jc = jax.eval_shape(lambda: JModel(jcfg).init_cache(2, 32))
    tc = Model(cfg, device="cpu").init_cache(2, 32)
    assert [x.shape for x in jax.tree.leaves(jc)] == \
        [tuple(x.shape) for x in jax.tree.leaves(tc)]
    for axes in (("data",), ("pod", "data")):
        assert sharding.spec_leaves(sharding.cache_specs(tc, axes, msize)) \
            == _ref_specs(jsharding.cache_specs(jc, axes, msize))


@pytest.mark.parametrize("msize,n_data", [(1, 2), (2, 2), (2, 4), (4, 2)])
def test_zero_specs_equal_the_reference(msize, n_data):
    from repro.fl.distributed import zero_specs as j_zero_specs
    from repro.models import sharding as jsharding
    from repro_torch.fl.distributed import zero_specs
    from repro_torch.models import sharding

    _, _, jshapes, tp = _both_params(TRAIN)
    want = _ref_specs(j_zero_specs(jsharding.param_specs(jshapes, msize),
                                   jshapes, n_data))
    got = sharding.spec_leaves(zero_specs(sharding.param_specs(tp, msize),
                                          tp, n_data))
    assert got == want
    assert any("data" in s for s in got)


@pytest.mark.parametrize("arch,msize,split", [
    ("qwen2-7b", 2, True), ("qwen2-7b", 4, True), ("qwen2-7b", 8, False),
    ("qwen3-32b", 8, True), ("internvl2-1b", 4, False),
    ("stablelm-1.6b", 8, True)])
def test_placement_keeps_attention_whole_headed(arch, msize, split):
    """The port splits attention only into whole q and kv heads: where
    the heads do not divide (qwen2-7b's 28 / 4 at m = 8, internvl2's 14 /
    2 at m = 4) every attention leaf stays whole; everything else follows
    ``param_specs``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.models import sharding
    from repro_torch.models.model import Model

    cfg = get_config(arch)
    with FakeTensorMode():
        params = Model(cfg, device="cpu").init(torch.Generator())
    paths = sharding._paths(params)
    rule = sharding.spec_leaves(sharding.param_specs(params, msize))
    got = sharding.spec_leaves(sharding.placement_specs(params, cfg, msize))
    for path, r, g in zip(paths, rule, got):
        if sharding._ATTN_LEAF.search(path):
            assert ("model" in g) == split, path
            assert "model" in r, path
        else:
            assert g == r, path


def test_local_shard_and_its_gather_on_one_rank():
    from repro_torch.models import sharding

    x = torch.arange(24.0).reshape(2, 3, 4)
    parts = [sharding.local_shard(x, (None, None, "model"), r, 2)
             for r in range(2)]
    assert [tuple(p.shape) for p in parts] == [(2, 3, 2)] * 2
    torch.testing.assert_close(torch.cat(parts, 2), x, rtol=0, atol=0)
    assert sharding.local_shard(x, (None, None, None), 1, 2) is x
    assert sharding.gather_shard(x, (None, "model", None), None, 1) is x


def test_collectives_are_the_identity_without_a_group():
    from repro_torch.models import sharding

    x = torch.randn(3, 4, requires_grad=True)
    assert sharding.copy_to_model(x) is x
    assert sharding.reduce_from_model(x) is x
    assert sharding.model_rank() == (0, 1)
    for f in (sharding.all_reduce_both, sharding.gather_seq,
              sharding.scatter_seq, sharding.split_seq,
              sharding.own_rows_grad):
        assert f(x) is x
    assert not sharding.seq_parallel(7)  # no group: nothing splits
    with pytest.raises(RuntimeError, match="model group"):
        sharding.all_reduce_max(x)


def test_a_shard_without_a_model_group_raises():
    """A layer whose weights are narrower than the config's holds a shard:
    run with no model group it would return partial sums, so it raises."""
    from repro_torch.models import sharding
    from repro_torch.models.layers import mlp_apply

    assert not sharding.holds_shard(8, 8)
    p = {"gate": torch.randn(4, 4), "up": torch.randn(4, 4),
         "down": torch.randn(4, 4)}
    x = torch.randn(2, 4)
    torch.testing.assert_close(mlp_apply(p, x, "swiglu", 4),
                               mlp_apply(p, x), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="model group"):
        mlp_apply(p, x, "swiglu", 8)


def _rank_gb(arch, m, batch=2, cache_len=4096):
    """GB a rank of a model group of ``m`` holds, from the full config's
    shapes alone (an init under ``FakeTensorMode``): the weights under the
    port's placement and under the reference's rule (``param_specs``);
    the decode cache of ``batch`` x ``cache_len`` tokens as a rank's
    layers make it (``init_cache`` with the group's size: its kv heads
    where they split, else all of them; its SSD heads and conv channels,
    ``w_B`` / ``w_C``'s whole unless ``whole_groups``) and under the
    reference's ``cache_specs`` (the sequence over 'model')."""
    from unittest import mock

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.models import sharding
    from repro_torch.models.model import Model

    cfg = get_config(arch)
    with FakeTensorMode():
        model = Model(cfg, device="cpu")
        params = model.init(torch.Generator())
        cache = model.init_cache(batch, cache_len)
        with mock.patch.object(sharding, "model_rank", lambda: (0, m)):
            rank_cache = model.init_cache(batch, cache_len)

    def gb(tree, specs=None):
        if specs is None:
            specs = sharding._map_specs(lambda p, x: (None,) * x.ndim, tree)
        return sum(x.numel() * x.element_size()
                   // (m if "model" in s else 1)
                   for x, s in zip(tree_leaves(tree),
                                   sharding.spec_leaves(specs))) / 1e9

    return (gb(params, sharding.placement_specs(params, cfg, m)),
            gb(params, sharding.param_specs(params, m)),
            gb(rank_cache),
            gb(cache, sharding.cache_specs(cache, ("data",), m)))


# (arch, m): GB a rank (weights: placement, rule; cache: the rank's own,
# cache_specs), as configured (bf16), 2 x 4,096 tokens
@pytest.mark.parametrize("arch,m,want", [
    ("qwen2-7b", 2, (7.616, 7.616, 0.235, 0.235)),
    ("qwen2-7b", 8, (3.343, 1.904, 0.470, 0.059)),
    ("stablelm-1.6b", 8, (0.411, 0.411, 0.202, 0.201)),
    ("internvl2-1b", 4, (0.790, 0.724, 0.101, 0.025)),
    ("qwen1.5-4b", 8, (2.824, 0.988, 3.356, 0.420)),
    ("qwen3-32b", 4, (16.382, 16.382, 0.538, 0.537)),
    ("mamba2-1.3b", 2, (1.473, 1.448, 0.102, 0.102)),
    ("mamba2-1.3b", 4, (0.763, 0.725, 0.051, 0.051)),
    ("mamba2-1.3b", 8, (0.408, 0.364, 0.026, 0.025)),
    ("zamba2-2.7b", 2, (2.442, 2.424, 0.450, 0.450)),
    ("zamba2-2.7b", 4, (1.240, 1.214, 0.225, 0.225)),
    ("zamba2-2.7b", 8, (0.639, 0.608, 0.113, 0.113))])
def test_rank_bytes_of_the_placement(arch, m, want):
    """Where the heads split, a rank holds the rule's weights and its
    1/m of the cache; where they do not, more weights (the attention
    whole) and the whole cache.  The SSD's one group stays whole
    (``whole_groups``): a rank holds the rule's weights plus the rest of
    ``w_B`` / ``w_C`` (and, in its conv cache, of the B / C channels)."""
    from repro_torch.configs import get_config
    from repro_torch.models import sharding

    cfg = get_config(arch)
    got = _rank_gb(arch, m)
    assert [round(x, 3) for x in got] == list(want), got
    if not sharding.whole_heads(cfg, m):
        assert got[0] > got[1] and got[2] > m / 2 * got[3]
    elif cfg.family in ("ssm", "hybrid") and \
            not sharding.whole_groups(cfg, m):
        d, GN, L = cfg.d_model, cfg.ssm_groups * cfg.ssm_state, cfg.n_layers
        extra = 2 * L * d * GN * 2 * (1 - 1 / m) / 1e9   # w_B, w_C bf16
        assert got[0] - got[1] == pytest.approx(extra, rel=1e-6)
        assert got[3] <= got[2] <= 1.05 * got[3]
    else:
        assert got[0] == got[1]
        assert got[2] == pytest.approx(got[3], rel=1e-2)     # kpos whole


# ---------------------------------------------------------------------------
# the twin of dist_equivalence.py on (2, 2, 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mixing", MIXINGS)
def test_schedule_matches_the_reference_two_rounds(run, mixing):
    for t in range(ROUNDS):
        _close(_leaves(run, f"{mixing}/r{t}"), run.ref[f"r{t}"], ORACLE,
               f"{mixing} round {t}")


@pytest.mark.parametrize("mixing", MIXINGS)
def test_scanned_equals_sequential_bitwise(run, mixing):
    assert run.res[f"{mixing}/scan_bitwise"]


def test_zero_ring_matches_the_reference(run):
    for t in range(ROUNDS):
        _close(_leaves(run, f"zero/r{t}"), run.ref[f"r{t}"], ORACLE,
               f"zero round {t}")
    zero, plain = run.res["zero/numel"]
    assert zero < 0.55 * plain          # n_data = 2: about half a rank


@pytest.mark.parametrize("mixing", QMIX)
def test_quantized_schedule_within_the_rounding_allowance(run, mixing):
    for t in range(ROUNDS):
        want, allow = run.ref[f"q/{mixing}"][t]
        for got, w, a in zip(_leaves(run, f"q/{mixing}/r{t}"), want,
                             allow):
            off = ~np.isclose(got, w, **ORACLE)
            assert (np.abs(got - w)[off] <= a[off]).all(), \
                f"round {t}: {np.abs(got - w)[off].max()}"
    assert run.res[f"q/{mixing}/scan_bitwise"]


@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_moe_tensor_parallel_experts_match_the_reference(run, impl):
    _close(_leaves(run, f"moe/{impl}"), run.ref["moe"], ORACLE, impl)


def test_expert_parallel_moe_under_a_model_group_refuses(run):
    """It runs now: with ``moe_sharding='expert'`` a rank holds two whole
    experts (the tensor layout: every expert's ffn half), and the round
    equals the reference's (capacity 2 x the fair share drops nothing
    here: 32 tokens, top-2 of 4, a capacity of 32)."""
    (_, E_loc, d, ff), (_, E, d2, ff_loc) = run.res["moe/expert_shapes"]
    assert (E_loc, ff_loc) == (E // 2, ff // 2) and d == d2
    _close(_leaves(run, "moe/expert"), run.ref["moe"], ORACLE, "expert")


@pytest.mark.parametrize("mixing", MIXINGS)
@pytest.mark.parametrize("name", ZOO_TRAIN)
def test_mla_ssd_hybrid_rounds_match_the_reference(run, name, mixing):
    """One round at a 'model' axis of 2 (SSD heads 16 a rank, w_B / w_C
    whole, or one of two groups a rank; MLA 2 of 4 heads a rank;
    expert-parallel or tensor-parallel experts) against the reference's
    single-host round."""
    _close(_leaves(run, f"zoo/{name}/{mixing}"),
           run.ref[f"zoo/{name.partition('+')[0]}"], ORACLE,
           f"{name} {mixing}")


@pytest.mark.parametrize("remat", [False, True])
def test_two_rank_gradient_equals_one_rank_and_the_reference(run, remat):
    """Rematerialised layers run their collectives again in backward:
    both ranks recompute in the same order (no deadlock), and the
    gradients do not change."""
    got_loss, one_loss = run.res[f"grad/{remat}/loss"]
    np.testing.assert_allclose(got_loss, one_loss, rtol=1e-6)
    np.testing.assert_allclose(got_loss, run.ref[f"grad/{remat}/loss"],
                               rtol=2e-5)
    got = _leaves(run, f"grad/{remat}")
    _close(got, _leaves(run, f"grad/{remat}/one_rank"), ORACLE, "one rank")
    _close(got, run.ref[f"grad/{remat}"], ORACLE, "reference")


@pytest.mark.parametrize("mixing,scan", SERVER_CASES)
def test_mesh_engine_history_matches_local_engine(run, mixing, scan):
    params, cols = run.local[(mixing, scan)]
    assert run.res[f"server/{mixing}/{scan}/hist"] == cols
    assert len(cols) == ROUNDS
    _close(_leaves(run, f"server/{mixing}/{scan}"), params, ORACLE)


def test_every_rank_holds_the_same_whole_params(run):
    keys = [k for k in run.digests[0] if not k.startswith("serve/")]
    assert len(keys) == len(MIXINGS) * ROUNDS + ROUNDS \
        + len(QMIX) * ROUNDS + 3 + 4 + len(SERVER_CASES) \
        + len(ZOO_TRAIN) * len(MIXINGS)
    for d in run.digests[1:]:
        assert {k: d[k] for k in keys} == {k: run.digests[0][k]
                                           for k in keys}


# ---------------------------------------------------------------------------
# the twin of serve_equivalence.py on (2, 4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SERVE)
def test_serve_steps_match_the_reference(run, name):
    want_pre, want_dec = run.ref[f"serve/{name}"]
    covered = np.zeros(SB, bool)
    for r in range(WORLD):
        start, stop, pre, dec = run.res[f"serve/{name}/{r}"]
        assert pre.shape == (stop - start, 128)      # full vocab
        np.testing.assert_allclose(pre, want_pre[start:stop], **SERVE_TOL)
        np.testing.assert_allclose(dec, want_dec[start:stop], **SERVE_TOL)
        covered[start:stop] = True
    assert covered.all()


@pytest.mark.parametrize("name,heads", [("qwen2-7b", 1), ("qwen3-gqa", 1),
                                        ("stablelm-1.6b", 1)])
def test_serve_cache_holds_the_ranks_kv_heads(run, name, heads):
    got, want = run.res[f"serve/{name}/cache_heads"]
    assert got == want == heads


@pytest.mark.parametrize("name,want", [
    ("mamba2-1.3b", ((8, 160), (8, 160))),
    ("zamba2-2.7b", ((8, 160), (8, 160))),
    ("deepseek-v2-236b", ((SK + 4, 64), (SK + 4, 64)))])
def test_serve_cache_of_ssd_and_mla(run, name, want):
    """At m = 4: a rank's SSD state holds 8 of 32 heads and its conv 160
    channels (128 of x, B and C whole: 16 + 16); MLA's latent ring is
    whole on every rank."""
    assert run.res[f"serve/{name}/cache_heads"] == want


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "deepseek-v2-236b"])
@pytest.mark.parametrize("what", ["prefill", "decode", "train"])
def test_what_13b_ii_holds_raises(run, arch, what):
    """What once raised at a 'model' axis above 1 runs: the mesh prefill
    and decode steps at (2, 4) and a 'fused' round at (2, 2, 2) match the
    reference's single-host paths."""
    if what == "train":
        _close(_leaves(run, f"zoo/{arch}/fused"), run.ref[f"zoo/{arch}"],
               ORACLE, arch)
        return
    want = run.ref[f"serve/{arch}"][what == "decode"]
    for r in range(WORLD):
        start, stop, pre, dec = run.res[f"serve/{arch}/{r}"]
        got = dec if what == "decode" else pre
        np.testing.assert_allclose(got, want[start:stop], **SERVE_TOL)


if __name__ == "__main__" and len(sys.argv) == 4 \
        and sys.argv[1] == "worker":
    sys.path.insert(0, str(SRC))
    _worker(int(sys.argv[2]), Path(sys.argv[3]))
