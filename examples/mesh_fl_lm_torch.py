"""Semi-decentralized FL of a transformer LM on a mesh of ranks, on the
PyTorch port (the twin of ``examples/mesh_fl_lm.py``).

Four ranks, one client each, on a (pod, data, model) = (2, 2, 1) mesh: a
reduced qwen2-style LM, clients = (pod, data) mesh indices, ring D2D
mixing over the intra-pod axis, connectivity-aware m(t) from the sampled
cluster topology each round -- all driven by the declarative plan /
engine API: the trajectory is ONE ``RoundPlan`` (Algorithm 1's rule,
optionally with straggler dropout) and the mesh runtime is ONE
``ExecutionConfig``.  The reference's mesh is (2, 2, 2); the port's
'model' axis (tensor parallelism inside a client) waits for ROADMAP
queue 1 item 13b, so it is 1 here.

    PYTHONPATH=src python examples/mesh_fl_lm_torch.py --device cpu \\
        [--rounds 3] [--dropout 0.25] [--plan-out plan.json]

``--device cpu`` spawns four gloo ranks on the CPU; the default, cuda,
spawns four NCCL ranks, one card each (four cards).  Rank 0 prints the
rounds and then serves the trained model (prefill + greedy decode).
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
from repro_torch.fl.engine import ExecutionConfig
from repro_torch.fl.plan import RoundPlan
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.model import Model

SHAPE = (2, 2, 1)                       # (pod, data, model)
WORLD = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank, args, port):
    cpu = args.device == "cpu"
    if not cpu:
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=300))
    try:
        _train(rank, args, make_debug_mesh(SHAPE, device=args.device))
    finally:
        dist.destroy_process_group()


def _train(rank, args, mesh):
    n, c = 4, 2                           # clients, clusters (= pods)
    cfg = dataclasses.replace(get_config("qwen2-7b", reduced=True),
                              vocab_size=256)
    device = torch.device("cpu") if args.device == "cpu" else \
        torch.device("cuda", rank)
    model = Model(cfg, device=device)
    # every rank draws the same global params from the same seed
    params = model.init(torch.Generator(device).manual_seed(0))
    if rank == 0:
        print(f"model: {cfg.name}  params={model.param_count(params):,}  "
              f"mesh {SHAPE} on {args.device}")

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
    if rank != 0:
        return
    for rec in history.records:
        print(f"round {rec.t}: m(t)={rec.m_actual}/{n}  d2s={rec.d2s}  "
              f"loss={rec.metrics['loss']:.4f}")
    if args.plan_out:
        server.last_plan.save(args.plan_out)
        print(f"trajectory pinned to {args.plan_out} "
              "(re-run it with server.run(plan=RoundPlan.load(path)))")

    # serve the trained model: prefill + greedy decode
    prompt = torch.as_tensor(np.asarray(stream[:16])[None], device=device)
    out = model.generate(server.params, prompt, n_new=8)
    print("generated:", out[0].tolist())


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
    if args.device == "cuda" and torch.cuda.device_count() < WORLD:
        raise SystemExit(
            f"--device cuda needs {WORLD} CUDA devices (one a rank), found "
            f"{torch.cuda.device_count()}; pass --device cpu for gloo ranks")
    if args.device == "cpu":
        os.environ.setdefault("OMP_NUM_THREADS", "1")
    mp.spawn(_rank, args=(args, _free_port()), nprocs=WORLD, join=True)


if __name__ == "__main__":
    main()
