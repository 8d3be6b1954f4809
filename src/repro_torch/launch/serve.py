"""Batched serving CLI: prefill + greedy decode loop on a mesh of ranks
(port of ``repro.launch.serve``).

Runs the reduced architecture (vocab 512) from random weights made from
``--seed`` through the mesh prefill / decode steps
(``fl.distributed.make_prefill_step`` / ``make_decode_step``) on
``--devices N`` ranks, on the reference's mesh: (N // 4, 4) over
('data', 'model') for N >= 4, else (1, N).  As there, a mesh takes the
first (N // 4) * 4 ranks where N >= 4 is not a multiple of 4.  Every rank
draws the same whole params from the seed and keeps its shards
(``distributed.shard_params``); the batch is split over 'data' where the
data axis divides it, else every client serves the whole batch.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --batch 4 --prompt-len 32 --new-tokens 16 [--devices 4] [--device cpu]

The default spawns N NCCL ranks, one card each (``--devices 1``: this
process is the one rank); with more ranks than cards, or without a card,
it exits with an error -- it never falls back to the CPU.  ``--device
cpu`` runs N gloo ranks on the CPU.  Every architecture of the zoo runs:
dense, MoE (with MLA), SSM, hybrid, audio and vlm.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from dataclasses import replace
from datetime import timedelta
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import arch_names, get_config
from repro_torch.fl import distributed as D
from repro_torch.fl.engine import resolve_device
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.model import Model

# a collective that waits this long has lost a rank
TIMEOUT_S = 300


def mesh_shape(devices: int) -> Tuple[int, int]:
    """The reference's serving mesh over ('data', 'model') for
    ``devices`` devices: (devices // 4, 4) from 4 on, else (1, devices)."""
    return (devices // 4, 4) if devices >= 4 else (1, devices)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gather_rows(x: torch.Tensor, mesh, split: bool) -> torch.Tensor:
    """This rank's rows of the batch -> the whole batch's, in row order
    (an all-gather over 'data' where the batch is split there)."""
    n = int(mesh.shape[mesh.mesh_dim_names.index("data")])
    if not split or n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group("data"))
    return torch.cat(parts)


def serve(mesh, cfg, params, prompts: torch.Tensor,
          prefix: Optional[torch.Tensor] = None,
          new_tokens: int = 16) -> dict:
    """The serving loop on one rank of ``mesh`` (every rank calls it).

    params: the whole tree, the same on every rank (this rank keeps its
    shards); prompts (B, K) [, prefix (B, P, fdim)]: the whole batch.
    Prefills a cache of P + K + ``new_tokens`` positions, then decodes
    greedily ``new_tokens - 1`` steps, each rank its rows of the batch.
    Returns, on every rank, ``tokens`` (B, new_tokens) and ``logits`` (B,
    new_tokens, V) fp32 of the whole batch (gathered over 'data'), and
    ``prefill_s`` / ``decode_s``: each phase from a barrier to the
    barrier after the slowest rank's last step."""
    device = D.mesh_device(mesh)
    B, K = prompts.shape
    P = cfg.frontend_len if cfg.frontend else 0
    n_data = int(mesh.shape[mesh.mesh_dim_names.index("data")])
    baxes = ("data",) if B % n_data == 0 else None
    rows = D.batch_rows(mesh, baxes, B)
    local = D.shard_params(params, cfg, mesh)
    prefill = D.make_prefill_step(cfg, mesh, baxes,
                                  cache_len=P + K + new_tokens)
    decode = D.make_decode_step(cfg, mesh, baxes)

    def clock() -> float:
        _sync(device)
        dist.barrier()
        return time.perf_counter()

    t0 = clock()
    logits, cache = prefill(local, prompts, prefix)
    t_prefill = clock() - t0

    steps = [logits]
    token = torch.zeros(B, dtype=torch.long, device=device)
    t0 = clock()
    for i in range(new_tokens - 1):
        token[rows] = torch.argmax(logits, -1)
        logits, cache = decode(local, cache, token, P + K + i)
        steps.append(logits)
    t_decode = clock() - t0
    logits = _gather_rows(torch.stack(steps, 1).float(), mesh,
                          baxes is not None)
    return dict(tokens=torch.argmax(logits, -1), logits=logits,
                prefill_s=t_prefill, decode_s=t_decode)


def serve_rank(rank: int, args: argparse.Namespace, store: str) -> dict:
    """One rank of the CLI's run: joins the process group (gloo with
    ``--device cpu``, else NCCL on card ``rank``) at ``store``, builds the
    mesh, draws the weights and the prompts from ``--seed`` and
    ``serve``s them; rank 0 prints the reference's lines.  Returns
    ``serve``'s dict with ``cfg``, ``params`` (the whole tree) and
    ``mesh`` (its shape by axis)."""
    shape = mesh_shape(args.devices)
    world = int(np.prod(shape))
    cpu = args.device == "cpu"
    device = torch.device("cpu") if cpu else torch.device("cuda", rank)
    if not cpu:
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S),
                            **({} if cpu else {"device_id": device}))
    try:
        mesh = make_debug_mesh(shape, ("data", "model"), device=device.type)
        axes = dict(zip(mesh.mesh_dim_names, shape))
        cfg = replace(get_config(args.arch, reduced=True), vocab_size=512)
        model = Model(cfg, device)
        params = model.init(torch.Generator(device=device)
                            .manual_seed(args.seed))
        rng = np.random.default_rng(args.seed)
        B, K = args.batch, args.prompt_len
        prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, K)),
                                  device=device)
        prefix = None
        if cfg.frontend:
            prefix = torch.as_tensor(rng.standard_normal(
                (B, cfg.frontend_len, cfg.frontend_dim)),
                dtype=torch.float32, device=device)
        if rank == 0:
            print(f"mesh: {axes}")
            print(f"{cfg.name}: {model.param_count(params):,} params on "
                  f"{world} {device.type} rank{'s' if world > 1 else ''}")
        out = serve(mesh, cfg, params, prompts, prefix, args.new_tokens)
        if rank == 0:
            n = args.new_tokens - 1
            print(f"prefill: {B}x{K} tokens in "
                  f"{out['prefill_s'] * 1e3:.1f} ms")
            print(f"decode:  {n} steps x {B} seqs in "
                  f"{out['decode_s'] * 1e3:.1f} ms "
                  f"({n * B / max(out['decode_s'], 1e-9):.0f} tok/s)")
            toks = out["tokens"].cpu().numpy()
            for b in range(min(B, 2)):
                print(f"  seq{b}: {toks[b].tolist()}")
        out.update(cfg=cfg, params=params, mesh=axes)
        return out
    finally:
        dist.destroy_process_group()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-7b", choices=arch_names())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks of the mesh (the reference's rule: "
                         "(N // 4, 4) over ('data', 'model') from 4 on, "
                         "else (1, N)); one card each")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="cuda (default): NCCL ranks, one card each; cpu: "
                         "gloo ranks on the CPU (required to run without "
                         "a GPU)")
    args = ap.parse_args(argv)
    if args.devices < 1:
        ap.error("--devices must be at least 1")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        args.device = resolve_device(args.device).type
    except RuntimeError as e:
        raise SystemExit(str(e))
    world = int(np.prod(mesh_shape(args.devices)))
    if args.device == "cuda" and world > torch.cuda.device_count():
        raise SystemExit(
            f"--devices {args.devices} needs {world} CUDA devices (one a "
            f"rank; NCCL takes no two ranks on one card), found "
            f"{torch.cuda.device_count()}; pass --device cpu for gloo "
            "ranks on the CPU")
    tmp = tempfile.mkdtemp(prefix="serve-")
    store = os.path.join(tmp, "store")
    try:
        if world == 1:
            serve_rank(0, args, store)
        else:
            import torch.multiprocessing as mp
            if args.device == "cpu":
                os.environ.setdefault("OMP_NUM_THREADS", "1")
            mp.spawn(serve_rank, args=(args, store), nprocs=world, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
