"""Semi-decentralized FL of a transformer LM on a mesh of ranks, on the
PyTorch port (the twin of ``examples/mesh_fl_lm.py``).

A (pod, data, model) mesh: a reduced qwen2-style LM, clients = (pod,
data) mesh indices, each client's weights split over its 'model' ranks
(tensor parallelism), ring D2D mixing over the intra-pod axis,
connectivity-aware m(t) from the sampled cluster topology each round --
all driven by the declarative plan / engine API: the trajectory is ONE
``RoundPlan`` (Algorithm 1's rule, optionally with straggler dropout)
and the mesh runtime is ONE ``ExecutionConfig``.  The trained model is
then served on the same mesh (the mesh prefill and decode steps, greedy).

    PYTHONPATH=src python examples/mesh_fl_lm_torch.py --device cpu \
        [--rounds 3] [--dropout 0.25] [--plan-out plan.json]

``--device cpu`` spawns eight gloo ranks on the CPU on the reference's
mesh, (2, 2, 2): four clients in two pods.  The default, cuda, spawns
four NCCL ranks, one card each, on (1, 2, 2): two clients in one pod.
Rank 0 prints the rounds and the generated tokens.
"""

import argparse
import dataclasses
import os
import socket
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import topology
from repro_torch.configs import get_config
from repro_torch.core.server import FederatedServer, ServerConfig
from repro_torch.data import lm_batches, make_token_stream
from repro_torch.fl import distributed as D
from repro_torch.fl.engine import ExecutionConfig
from repro_torch.fl.plan import RoundPlan
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.model import Model

SHAPES = {"cpu": (2, 2, 2), "cuda": (1, 2, 2)}      # (pod, data, model)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank, args, port):
    cpu = args.device == "cpu"
    shape = SHAPES[args.device]
    if not cpu:
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=int(np.prod(shape)),
                            timeout=timedelta(seconds=300))
    try:
        _train(rank, args, make_debug_mesh(shape, device=args.device))
    finally:
        dist.destroy_process_group()


def _train(rank, args, mesh):
    pods, n_data, _ = mesh.shape
    n, c = pods * n_data, pods            # clients, clusters (= pods)
    cfg = dataclasses.replace(get_config("qwen2-7b", reduced=True),
                              vocab_size=256)
    device = D.mesh_device(mesh)
    model = Model(cfg, device=device)
    # every rank draws the same global params from the same seed
    params = model.init(torch.Generator(device).manual_seed(0))
    if rank == 0:
        print(f"model: {cfg.name}  params={model.param_count(params):,}  "
              f"mesh {tuple(mesh.shape)} on {args.device}")

    # the whole run is two declarative objects: the trajectory plan and
    # the runtime selection (mesh + ring D2D mixing)
    network = topology.make_spec("k_regular", n=n, c=c, k_range=(1, 2),
                                 p_fail=0.0).build()
    scfg = ServerConfig(T=args.T, t_max=args.rounds, phi_max=args.phi_max,
                        bound_kind="regular", seed=0, eta=lambda t: 0.05)
    plan = RoundPlan.connectivity_aware(network, scfg)
    if args.dropout > 0:
        plan = plan.with_dropout(args.dropout, np.random.default_rng(1))
    execution = ExecutionConfig(backend="ring", mesh=mesh, model_cfg=cfg)

    B, S = 2, 32
    stream = make_token_stream(n_tokens=1 << 15, vocab=cfg.vocab_size,
                               seed=0)

    def sampler(rng, t):
        """Per-round (n, T, B, S+1) token minibatches from the stream."""
        xs, ys = lm_batches(stream, rng, n, args.T, B, S)
        return torch.cat([xs, ys[..., -1:]], dim=-1)   # next-token tail

    def eval_fn(prm):
        toks = sampler(np.random.default_rng(123), 0).to(device)
        return {"loss": float(model.loss(prm, (toks[0, 0, :, :-1],
                                               toks[0, 0, :, 1:])))}

    server = FederatedServer(network, None, params, sampler, scfg,
                             algorithm="semidec", execution=execution)
    history = server.run(eval_fn=eval_fn, plan=plan)
    if rank == 0:
        for rec in history.records:
            print(f"round {rec.t}: m(t)={rec.m_actual}/{n}  "
                  f"d2s={rec.d2s}  loss={rec.metrics['loss']:.4f}")
        if args.plan_out:
            server.last_plan.save(args.plan_out)
            print(f"trajectory pinned to {args.plan_out} "
                  "(re-run it with server.run(plan=RoundPlan.load(path)))")

    # serve the trained model on the mesh: every rank its shards, the
    # one prompt on every client (no batch axis); prefill + greedy decode
    n_new, prompt = 8, torch.as_tensor(np.asarray(stream[:16])[None],
                                       device=device)
    local = D.shard_params(server.params, cfg, mesh)
    prefill = D.make_prefill_step(cfg, mesh, (), prompt.shape[1] + n_new)
    decode = D.make_decode_step(cfg, mesh, ())
    logits, cache = prefill(local, prompt)
    out = [torch.argmax(logits, -1)]
    for i in range(n_new - 1):
        logits, cache = decode(local, cache, out[-1], prompt.shape[1] + i)
        out.append(torch.argmax(logits, -1))
    if rank == 0:
        print("generated:", torch.stack(out, 1)[0].tolist())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: NCCL ranks, one card each; cpu: gloo")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--T", type=int, default=2)
    ap.add_argument("--phi-max", type=float, default=1.0)
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-round client straggler probability")
    ap.add_argument("--plan-out", default="",
                    help="save the executed RoundPlan as JSON")
    args = ap.parse_args(argv)
    world = int(np.prod(SHAPES[args.device]))
    if args.device == "cuda" and torch.cuda.device_count() < world:
        raise SystemExit(
            f"--device cuda needs {world} CUDA devices (one a rank), found "
            f"{torch.cuda.device_count()}; pass --device cpu for gloo ranks")
    if args.device == "cpu":
        os.environ.setdefault("OMP_NUM_THREADS", "1")
    mp.spawn(_rank, args=(args, _free_port()), nprocs=world, join=True)


if __name__ == "__main__":
    main()
