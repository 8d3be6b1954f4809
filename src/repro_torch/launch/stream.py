"""Semi-asynchronous training CLI: StreamEngine + fault injection (port
of ``repro.launch.stream``).

Runs the Sec. 6 experiment under a declarative fault process: clients
fail (i.i.d. / bursty Markov / whole-cluster), upload with latency drawn
from a named distribution, deliver duplicates, or depart permanently,
while the server closes rounds FedBuff-style (``--buffer b``) or on a
deadline, discounting stale uploads by ``--staleness poly|exp``.

  PYTHONPATH=src python -m repro_torch.launch.stream --rounds 30 \\
      --faults "markov:p_fail=0.2,latency=exponential,mean=0.5" \\
      --buffer 40 --deadline 2.0 --staleness poly

Runs on ``cuda`` unless ``--device cpu`` (with no GPU and no --device it
exits with an error).

The fault process is declarative and replayable: ``--faults`` parses a
``FaultSpec`` ('kind:key=val,...' like ``--topology``), and spec + seed
fully determine the trajectory.  ``--plan-out`` saves the *realized*
plan (faults folded into ``active_t`` / ``arrival_t``) -- replaying it
with ``--plan`` reproduces the run bitwise with no fault sampling.

``--selfcheck`` runs the two locked equivalences on a synthetic problem
(on ``--device``) and exits non-zero on any mismatch:

* no faults, full buffer, zero staleness: StreamEngine reproduces
  LocalEngine's History bitwise (the fast path IS the sync round fn);
* a seeded FaultSpec trajectory replays bitwise after a JSON round-trip
  of the spec and of the realized plan.
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
from repro_torch.fl.plan import RoundPlan
from repro_torch.fl.stream import StreamConfig
from repro_torch.models import cnn as cnn_lib

from .train import build_model


def _stream_config(args) -> StreamConfig:
    spec = parse_fault_spec(args.faults) if args.faults else None
    if spec is not None and spec == FaultSpec():
        spec = None                     # 'none' == no fault process
    return StreamConfig(
        buffer=args.buffer,
        deadline=args.deadline if args.deadline > 0 else math.inf,
        staleness=args.staleness, staleness_param=args.staleness_param,
        max_staleness=args.max_staleness,
        faults=spec, fault_seed=args.fault_seed)


# ---------------------------------------------------------------------------
# --selfcheck: the locked equivalences, on a fast synthetic problem
# ---------------------------------------------------------------------------

def _quad_loss(params, batch):
    x = params["x"]
    b, = batch
    return 0.5 * torch.sum((x - b.mean(dim=0)) ** 2)


def _check_setup(backend, stream, device, n=12, c=2, rounds=6, p=4,
                 seed=3):
    net = topology.make_spec("k_regular", n=n, c=c, k_range=(4, 6),
                             p_fail=0.1).build()
    cfg = ServerConfig(T=3, t_max=rounds, phi_max=0.3, seed=seed,
                       eta=lambda t: 0.2 / (1 + 0.3 * t))
    targets = np.random.default_rng(11).standard_normal((n, p)) \
        .astype(np.float32)

    def sampler(r, t):
        samp = targets[:, None, None, :] \
            + 0.05 * r.standard_normal((n, 3, 2, p))
        return (torch.as_tensor(samp, dtype=torch.float32),)

    server = FederatedServer(
        net, _quad_loss, {"x": torch.zeros(p)}, sampler, cfg,
        execution=ExecutionConfig(backend=backend, stream=stream),
        device=device)
    return server


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

    # 1) pristine StreamEngine == LocalEngine, bitwise
    sync = _check_setup(backend, None, device)
    h_sync = sync.run()
    semi = _check_setup(backend, StreamConfig(), device)
    h_semi = semi.run()
    same_params = torch.equal(sync.params["x"], semi.params["x"])
    if not (same_params and _histories_equal(h_sync, h_semi)):
        failures.append("no-fault StreamEngine != LocalEngine")

    # 2) seeded FaultSpec replays bitwise through its JSON round-trip,
    #    and the realized plan replays with no fault sampling at all
    spec = parse_fault_spec(
        "markov:p_fail=0.2,latency=exponential,mean=0.4,"
        "duplicate_rate=0.1")
    stream = StreamConfig(buffer=8, deadline=0.6, staleness="poly",
                          faults=spec, fault_seed=5)
    s1 = _check_setup(backend, stream, device)
    h1 = s1.run()
    stream_rt = StreamConfig(
        buffer=8, deadline=0.6, staleness="poly",
        faults=FaultSpec.from_json(spec.to_json()), fault_seed=5)
    s2 = _check_setup(backend, stream_rt, device)
    h2 = s2.run()
    if not (torch.equal(s1.params["x"], s2.params["x"])
            and _histories_equal(h1, h2)):
        failures.append("FaultSpec JSON round-trip replay diverged")
    realized = RoundPlan.from_json(s1.engine.last_realized_plan.to_json())
    s3 = _check_setup(backend, StreamConfig(
        buffer=8, deadline=0.6, staleness="poly"), device)
    s3.run(plan=realized)
    if not torch.equal(s1.params["x"], s3.params["x"]):
        failures.append("realized-plan replay diverged")

    for f in failures:
        print(f"SELFCHECK FAIL [{backend} on {device}]: {f}")
    if not failures:
        print(f"selfcheck [{backend} on {device}]: no-fault bitwise "
              "equivalence, fault replay, realized-plan replay -- all OK")
    return 1 if failures else 0


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--algorithm", default="semidec",
                    choices=("semidec", "fedavg", "colrel"))
    ap.add_argument("--model", default="cnn",
                    choices=("cnn", "mlp", "logreg"))
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--n", type=int, default=70)
    ap.add_argument("--clusters", type=int, default=7)
    ap.add_argument("--T", type=int, default=5)
    ap.add_argument("--phi-max", type=float, default=0.06)
    ap.add_argument("--m", type=int, default=None,
                    help="fixed sample size (fedavg/colrel)")
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
                         "uploads land (default: wait for the round's "
                         "own full cohort)")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="max virtual time a round stays open after "
                         "dispatch (0 = no deadline)")
    ap.add_argument("--staleness", default="none",
                    choices=("none", "poly", "exp"),
                    help="discount for uploads consumed s closures "
                         "after dispatch")
    ap.add_argument("--staleness-param", type=float, default=0.5)
    ap.add_argument("--max-staleness", type=int, default=16,
                    help="discard uploads older than this many closures")
    # -- fault process ------------------------------------------------------
    ap.add_argument("--faults", default="",
                    help="declarative fault spec 'kind:key=val,...', "
                         "e.g. 'markov:p_fail=0.2,latency=exponential,"
                         "mean=0.5,duplicate_rate=0.05'")
    ap.add_argument("--fault-seed", type=int, default=0)
    # -- artifacts ----------------------------------------------------------
    ap.add_argument("--plan", default="",
                    help="replay a saved (realized) RoundPlan JSON; "
                         "combine with no --faults to re-run a recorded "
                         "fault trajectory verbatim")
    ap.add_argument("--plan-out", default="",
                    help="save the REALIZED plan (faults folded into "
                         "active_t/arrival_t) as replayable JSON")
    ap.add_argument("--out", default="")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--selfcheck", action="store_true",
                    help="run the locked bitwise equivalences on a "
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

    if args.topology:
        spec = topology.parse_spec(args.topology, n=args.n,
                                   c=args.clusters)
    else:
        spec = topology.make_spec("k_regular", n=args.n, c=args.clusters,
                                  k_range=(args.k_min, args.k_max),
                                  p_fail=args.p)
    network = spec.build()
    cfg = ServerConfig(
        T=args.T, t_max=args.rounds, phi_max=args.phi_max,
        m_fixed=args.m, seed=args.seed,
        eta=lambda t: args.lr0 * (args.lr_decay ** t))
    server = FederatedServer(
        network, loss_fn, params, batcher, cfg,
        algorithm=args.algorithm,
        execution=ExecutionConfig(backend=args.backend,
                                  stream=_stream_config(args)),
        device=device)
    plan = RoundPlan.load(args.plan) if args.plan else None
    history = server.run(eval_fn=eval_fn, plan=plan)
    if args.plan_out:
        server.engine.last_realized_plan.save(args.plan_out)
        print(f"realized trajectory saved to {args.plan_out}")

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
    total = history.ledger.total_cost
    print(f"{args.algorithm} (semi-async) on {device} "
          f"({server.effective_backend} backend): total comm cost = "
          f"{total:.1f} "
          f"(D2S {history.ledger.total_d2s}, "
          f"D2D {history.ledger.total_d2d})")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"algorithm": args.algorithm,
                       "stream": {"buffer": args.buffer,
                                  "deadline": args.deadline,
                                  "staleness": args.staleness,
                                  "faults": args.faults or None,
                                  "fault_seed": args.fault_seed},
                       "rounds": rows, "total_cost": total}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
