"""Wall-clock ingestion CLI: IngestEngine + replayable traffic recordings
(port of ``repro.launch.ingest``).

Runs the Sec. 6 experiment on the ``repro_torch.runtime`` wall-clock
runtime: client uploads arrive on real threads, the server closes rounds
FedBuff-style (``--buffer b``) or on a wall deadline (``--deadline-ms``),
and with ``--overlap`` round ``t+1`` trains while round ``t``'s
stragglers are still in flight.  Every run flushes a ``Recording`` --
the realized plan with *measured* arrival offsets plus the server
policy -- which ``--replay`` pushes back through the virtual-time
``StreamEngine`` and diffs bitwise against the live History.

  PYTHONPATH=src python -m repro_torch.launch.ingest --rounds 10 \\
      --faults "markov:p_fail=0.2,latency=exponential,mean=0.5" \\
      --buffer 40 --deadline-ms 50 --record-out rec.json
  PYTHONPATH=src python -m repro_torch.launch.ingest --rounds 10 \\
      --faults "markov:p_fail=0.2,latency=exponential,mean=0.5" \\
      --buffer 40 --deadline-ms 50 --replay rec.json

Runs on ``cuda`` unless ``--device cpu`` (with no GPU and no --device it
exits with an error).  A recording made by the JAX package's CLI
replays here (and one made here replays there) when the live run's
flags are passed: the JSON format and the plans are the same.

``--replay`` rebuilds the model/data from the SAME flags (the recording
pins traffic, not data: pass the seeds the live run used) and exits
non-zero on any History/params mismatch -- the subsystem's live/replay
anchor, also exercised synthetically by ``--selfcheck``.

``--clock virtual`` runs the same engine without threads (arrivals come
from the plan), which must reproduce ``StreamEngine`` bitwise.
"""

from __future__ import annotations

import argparse
import json
import math
import os
from functools import partial

import numpy as np
import torch

from repro_torch import topology
from repro_torch.core.rounds import MIXING_BACKENDS
from repro_torch.core.server import FederatedServer, ServerConfig
from repro_torch.data import (FederatedBatcher, label_sorted_partition,
                              make_classification)
from repro_torch.fl.engine import ExecutionConfig, resolve_device
from repro_torch.fl.faults import FaultSpec, parse_fault_spec
from repro_torch.fl.stream import StreamConfig
from repro_torch.models import cnn as cnn_lib
from repro_torch.runtime import (CLOCK_KINDS, DROP_POLICIES, Recording,
                                 RuntimeConfig)

from .train import build_model


def _stream_config(args) -> StreamConfig:
    spec = parse_fault_spec(args.faults) if args.faults else None
    if spec is not None and spec == FaultSpec():
        spec = None
    # --deadline-ms is WALL milliseconds; the engine's deadline stays in
    # virtual units (wall = virtual * time_scale)
    deadline = math.inf
    if args.deadline_ms > 0:
        deadline = args.deadline_ms / 1000.0 / args.time_scale
    return StreamConfig(
        buffer=args.buffer, deadline=deadline,
        staleness=args.staleness, staleness_param=args.staleness_param,
        max_staleness=args.max_staleness,
        client_optim=args.client_optim or None,
        faults=spec, fault_seed=args.fault_seed)


def _runtime_config(args) -> RuntimeConfig:
    return RuntimeConfig(
        clock=args.clock, time_scale=args.time_scale,
        workers=args.workers, overlap=not args.no_overlap,
        queue_capacity=args.queue_capacity or None,
        drop_policy=args.drop_policy, wall_budget=args.wall_budget)


def _build_problem(args, device):
    """Model + data + eval exactly as the live run defines them (the
    replay side rebuilds from the same flags; the recording pins
    traffic, not data)."""
    rng = np.random.default_rng(args.seed)
    ds_train = make_classification(n_samples=args.samples, seed=args.seed)
    ds_test = make_classification(n_samples=args.samples // 4,
                                  seed=args.seed + 1)
    parts = label_sorted_partition(ds_train, args.n, shards_per_client=2,
                                   rng=rng)
    batcher = FederatedBatcher(ds_train, parts, T=args.T,
                               batch_size=args.batch)
    params, apply_fn = build_model(args.model, args.seed)
    loss_fn = partial(cnn_lib.l2_regularized_loss, apply_fn)
    xs = torch.as_tensor(ds_test.x, device=device)
    ys = torch.as_tensor(ds_test.y, device=device).long()

    def eval_fn(p):
        with torch.no_grad():
            loss = float(loss_fn(p, (xs, ys)))
        return {"test_acc": cnn_lib.accuracy(apply_fn, p, xs, ys),
                "test_loss": loss}

    return loss_fn, params, batcher, eval_fn


def _build_server(args, loss_fn, params, batcher, runtime, device):
    if args.topology:
        spec = topology.parse_spec(args.topology, n=args.n,
                                   c=args.clusters)
    else:
        spec = topology.make_spec("k_regular", n=args.n, c=args.clusters,
                                  k_range=(args.k_min, args.k_max),
                                  p_fail=args.p)
    cfg = ServerConfig(
        T=args.T, t_max=args.rounds, phi_max=args.phi_max,
        seed=args.seed, eta=lambda t: args.lr0 * (args.lr_decay ** t))
    return FederatedServer(
        spec.build(), loss_fn, params, batcher, cfg,
        execution=ExecutionConfig(backend=args.backend,
                                  stream=_stream_config(args),
                                  runtime=runtime),
        device=device)


# ---------------------------------------------------------------------------
# --replay: the live/replay anchor against a saved Recording
# ---------------------------------------------------------------------------

def replay(args, device) -> int:
    recording = Recording.load(args.replay)
    loss_fn, params, batcher, _ = _build_problem(args, device)
    # the server draws batches from its seeded stream exactly like the
    # live run did; the recording's (possibly shutdown-sliced) plan
    # consumes the same prefix
    server = _build_server(args, loss_fn, params, batcher, None, device)
    _, batches = server._plan_and_batches(recording.plan)
    problems = recording.verify(loss_fn, server.params, batches,
                                backend=args.backend, device=device)
    meta = recording.meta
    print(f"replaying {args.replay}: {meta.get('rounds_done')} rounds, "
          f"clock={meta.get('clock')} overlap={meta.get('overlap')} "
          f"wall={meta.get('wall_seconds', float('nan')):.2f}s")
    for p in problems:
        print(f"REPLAY MISMATCH: {p}")
    if not problems:
        print("replay OK: History and final params match the live run "
              "bitwise")
    return 1 if problems else 0


# ---------------------------------------------------------------------------
# --selfcheck: the locked equivalences, on a fast synthetic problem
# ---------------------------------------------------------------------------

def _quad_loss(params, batch):
    x = params["x"]
    b, = batch
    return 0.5 * torch.sum((x - b.mean(dim=0)) ** 2)


def _quad_setup(backend, stream, runtime, device, n=12, c=2, rounds=6,
                p=4):
    net = topology.make_spec("k_regular", n=n, c=c, k_range=(4, 6),
                             p_fail=0.1).build()
    cfg = ServerConfig(T=3, t_max=rounds, phi_max=0.3, seed=3,
                       eta=lambda t: 0.2 / (1 + 0.3 * t))
    targets = np.random.default_rng(11).standard_normal((n, p)) \
        .astype(np.float32)

    def sampler(r, t):
        samp = targets[:, None, None, :] \
            + 0.05 * r.standard_normal((n, 3, 2, p))
        return (torch.as_tensor(samp, dtype=torch.float32),)

    return FederatedServer(
        net, _quad_loss, {"x": torch.zeros(p)}, sampler, cfg,
        execution=ExecutionConfig(backend=backend, stream=stream,
                                  runtime=runtime),
        device=device)


def _histories_equal(h1, h2) -> bool:
    if len(h1.records) != len(h2.records):
        return False
    for a, b in zip(h1.records, h2.records):
        if (a.t, a.m, a.m_actual, a.d2s, a.d2d) != \
                (b.t, b.m, b.m_actual, b.d2s, b.d2d):
            return False
        if a.stream != b.stream:
            return False
    return (h1.ledger.total_d2s == h2.ledger.total_d2s
            and h1.ledger.total_d2d == h2.ledger.total_d2d)


def selfcheck(backend: str, device) -> int:
    failures = []
    stream = StreamConfig(
        buffer=8, deadline=0.8, staleness="poly", max_staleness=4,
        faults=parse_fault_spec(
            "markov:p_fail=0.2,latency=exponential,mean=2.0,"
            "duplicate_rate=0.1"),
        fault_seed=5)

    # 1) virtual-clock IngestEngine == StreamEngine, bitwise
    s_stream = _quad_setup(backend, stream, None, device)
    h_stream = s_stream.run()
    s_virt = _quad_setup(backend, stream, RuntimeConfig(clock="virtual"),
                         device)
    h_virt = s_virt.run()
    if not (torch.equal(s_stream.params["x"], s_virt.params["x"])
            and _histories_equal(h_stream, h_virt)):
        failures.append("virtual IngestEngine != StreamEngine")

    # 2) a wall-clock overlapped run's recording replays bitwise through
    #    the virtual StreamEngine, across a JSON round-trip
    s_wall = _quad_setup(backend, stream, RuntimeConfig(
        clock="wall", time_scale=0.02, workers=4, overlap=True), device)
    s_wall.run()
    rec = Recording.from_json(s_wall.engine.last_recording.to_json())
    # a FRESH server: its batch rng stream starts at t=0 like the live
    # run's did (s_wall's own stream is already consumed by run())
    s_fresh = _quad_setup(backend, stream, None, device)
    _, batches = s_fresh._plan_and_batches(rec.plan)
    params0 = {"x": torch.zeros(4)}
    problems = rec.verify(_quad_loss, params0, batches, backend=backend,
                          device=device)
    failures.extend(f"wall recording replay: {p}" for p in problems)

    for f in failures:
        print(f"SELFCHECK FAIL [{backend} on {device}]: {f}")
    if not failures:
        print(f"selfcheck [{backend} on {device}]: virtual==stream "
              "bitwise, wall recording replays bitwise -- all OK")
    return 1 if failures else 0


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="cnn",
                    choices=("cnn", "mlp", "logreg"))
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--n", type=int, default=70)
    ap.add_argument("--clusters", type=int, default=7)
    ap.add_argument("--T", type=int, default=5)
    ap.add_argument("--phi-max", type=float, default=0.06)
    ap.add_argument("--p", type=float, default=0.1)
    ap.add_argument("--k-min", type=int, default=6)
    ap.add_argument("--k-max", type=int, default=9)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr0", type=float, default=0.02)
    ap.add_argument("--lr-decay", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--samples", type=int, default=7000)
    ap.add_argument("--backend", default="einsum",
                    choices=MIXING_BACKENDS)
    ap.add_argument("--topology", default="",
                    help="declarative topology spec 'family:key=val,...' "
                         f"(families: {', '.join(topology.families())})")
    # -- semi-async policy --------------------------------------------------
    ap.add_argument("--buffer", type=int, default=None,
                    help="FedBuff buffer size b: close a round once b "
                         "uploads land")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="max WALL milliseconds a round stays open after "
                         "dispatch (0 = no deadline); converted to "
                         "virtual units via --time-scale")
    ap.add_argument("--staleness", default="none",
                    choices=("none", "poly", "exp"))
    ap.add_argument("--staleness-param", type=float, default=0.5)
    ap.add_argument("--max-staleness", type=int, default=16)
    ap.add_argument("--client-optim", default="",
                    help="per-client optimizer assignment, e.g. 'sgd' or "
                         "'sgd,adam' (round-robin by client index)")
    # -- fault process ------------------------------------------------------
    ap.add_argument("--faults", default="",
                    help="declarative fault spec 'kind:key=val,...'")
    ap.add_argument("--fault-seed", type=int, default=0)
    # -- wall-clock runtime -------------------------------------------------
    ap.add_argument("--clock", default="wall", choices=CLOCK_KINDS,
                    help="'wall' measures real arrivals; 'virtual' must "
                         "reproduce StreamEngine bitwise")
    ap.add_argument("--time-scale", type=float, default=0.02,
                    help="wall seconds per virtual time unit")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--no-overlap", action="store_true",
                    help="disable dispatch-ahead (round t+1 waits for "
                         "round t's closure)")
    ap.add_argument("--queue-capacity", type=int, default=0,
                    help="bound the upload queue (0 = unbounded)")
    ap.add_argument("--drop-policy", default="block",
                    choices=DROP_POLICIES)
    ap.add_argument("--wall-budget", type=float, default=None,
                    help="graceful stop after this many wall seconds "
                         "(the recording still flushes and replays)")
    # -- artifacts ----------------------------------------------------------
    ap.add_argument("--record-out", default="",
                    help="save the run's Recording (measured arrivals + "
                         "policy + History digest) as replayable JSON")
    ap.add_argument("--replay", default="",
                    help="verify a saved Recording against a fresh "
                         "virtual replay (pass the live run's model/"
                         "data/seed flags); exits non-zero on mismatch")
    ap.add_argument("--out", default="")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--selfcheck", action="store_true",
                    help="run the locked live/replay equivalences on a "
                         "synthetic problem and exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; required to run "
                         "without a GPU, e.g. --device cpu)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    if args.selfcheck:
        return selfcheck(args.backend, device)
    if args.replay:
        return replay(args, device)

    loss_fn, params, batcher, eval_fn = _build_problem(args, device)
    server = _build_server(args, loss_fn, params, batcher,
                           _runtime_config(args), device)
    history = server.run(eval_fn=eval_fn)
    recording = server.engine.last_recording
    if args.record_out:
        recording.save(args.record_out)
        print(f"recording saved to {args.record_out}")

    rows = []
    for rec in history.records:
        row = dict(t=rec.t, m=rec.m_actual, d2s=rec.d2s, d2d=rec.d2d,
                   **rec.metrics)
        if rec.stream:
            row["stream"] = rec.stream
        rows.append(row)
        if not args.quiet:
            acc = rec.metrics.get("test_acc", float("nan"))
            extra = ""
            if rec.stream:
                keys = ("late", "lost", "dup", "deadline_hit", "shortfall")
                extra = "  " + " ".join(
                    f"{k}={rec.stream[k]:g}" for k in keys
                    if k in rec.stream)
            print(f"round {rec.t:3d}  m={rec.m_actual:3d} "
                  f"d2s={rec.d2s:4d}  acc={acc:.4f}{extra}", flush=True)
    wall = recording.meta.get("wall_seconds", float("nan"))
    done = len(history.records)
    rate = done / wall if wall and wall > 0 else float("nan")
    print(f"ingest ({args.clock}, overlap={not args.no_overlap}) on "
          f"{device}: "
          f"{done} rounds in {wall:.2f}s wall = {rate:.2f} rounds/s, "
          f"total comm cost = {history.ledger.total_cost:.1f}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"runtime": {"clock": args.clock,
                                   "time_scale": args.time_scale,
                                   "overlap": not args.no_overlap,
                                   "workers": args.workers},
                       "rounds": rows, "rounds_per_sec": rate,
                       "wall_seconds": wall}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
