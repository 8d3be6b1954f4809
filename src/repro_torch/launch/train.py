"""Paper-reproduction training CLI (Algorithm 1 vs baselines) on the
PyTorch/CUDA port.

Runs the experiment of Sec. 6: n=70 clients in c=7 clusters of 10,
k-regular digraphs (k ~ U{6..9}) with link-failure probability p, non-iid
label-sorted partition (2 label chunks per client), CNN / MLP / logreg on a
synthetic MNIST-shaped dataset, T=5 local SGD steps.

  PYTHONPATH=src python -m repro_torch.launch.train --algorithm semidec \\
      --rounds 30 --phi-max 0.06 --p 0.1
  PYTHONPATH=src python -m repro_torch.launch.train --algorithm fedavg --m 57

Runs on ``cuda`` unless ``--device cpu`` (with no GPU and no --device it
exits with an error).  Runtime selection is one ``ExecutionConfig``
(``--backend``, ``--scan``, ``--record-mixed``: without it the kernel
backends 'pallas'/'fused' take the aggregate-only kernel, with it they
run the mix / fused mix+aggregate kernels; 'sparse' runs the ELL
kernels: without --record-mixed the combine row into the aggregate kernel,
with it the fused sparse mix+aggregate kernel); ``--topology
'family:key=val,...'`` picks any registered graph family (default: the
paper's k_regular model from --k-min/--k-max/--p); ``--plan-out`` saves
the executed ``RoundPlan`` as JSON, ``--plan`` replays one verbatim (plans
are byte-identical to the JAX package's), and ``--dropout RATE`` adds
per-round client stragglers as a plan column (``--dropout-kind``: i.i.d.,
bursty Markov chains with ``--dropout-recover``, or whole clusters).
``--quant {int8,int4,fp8}`` quantizes the client payloads (with
``--quant-block``, ``--quant-rounding``, ``--no-error-feedback``): the
kernel backends then run the dequant kernels, and the plan written by
``--plan-out`` carries the spec.  ``--controller 'family:key=val,...'``
closes the loop (``repro_torch.control``: static, threshold,
similarity): the policy decides each round online, and ``--plan-out``
saves the realized plan, which ``--plan`` replays bitwise; it refuses
``--plan``, ``--dropout`` and ``--quant``.

  PYTHONPATH=src python -m repro_torch.launch.train --backend sparse \
      --topology ring:hops=1
  PYTHONPATH=src python -m repro_torch.launch.train --backend fused \
      --quant int8
  PYTHONPATH=src python -m repro_torch.launch.train \
      --controller threshold:tau=2 --plan-out realized.json
"""

from __future__ import annotations

import argparse
import json
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
from repro_torch.fl.packing import QuantSpec
from repro_torch.fl.plan import RoundPlan
from repro_torch.models import cnn as cnn_lib


def build_model(kind: str, seed: int = 0):
    if kind == "cnn":
        return cnn_lib.init_cnn(seed), cnn_lib.cnn_apply
    if kind == "mlp":
        return cnn_lib.init_mlp(seed), cnn_lib.mlp_apply
    return cnn_lib.init_logreg(seed), cnn_lib.logreg_apply


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
    ap.add_argument("--p", type=float, default=0.1,
                    help="D2D link failure probability")
    ap.add_argument("--k-min", type=int, default=6)
    ap.add_argument("--k-max", type=int, default=9)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr0", type=float, default=0.02)
    ap.add_argument("--lr-decay", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--samples", type=int, default=7000)
    ap.add_argument("--backend", default="einsum", choices=MIXING_BACKENDS,
                    help="mixing backend (ExecutionConfig.backend)")
    ap.add_argument("--scan", action="store_true",
                    help="run the whole trajectory from stacked plan "
                         "columns (make_scanned_rounds)")
    ap.add_argument("--record-mixed", action="store_true",
                    help="keep per-client mixed deltas (ExecutionConfig."
                         "record_mixed): 'fused' then runs the fused "
                         "mix+aggregate kernel and 'pallas' the mix "
                         "kernel instead of the aggregate-only one")
    ap.add_argument("--topology", default="",
                    help="declarative topology spec 'family:key=val,...' "
                         f"(families: {', '.join(topology.families())}); "
                         "default: the paper's k_regular model from "
                         "--k-min/--k-max/--p")
    ap.add_argument("--controller", default="",
                    help="close the loop: adaptive per-round control "
                         "'family:key=val,...' (families: static, "
                         "threshold, similarity -- see "
                         "repro_torch.control). The realized plan lands "
                         "in --plan-out like any other run.  Mutually "
                         "exclusive with --plan/--dropout/--quant; "
                         "semidec only")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-round client straggler probability "
                         "(adds an active_t column to the plan)")
    ap.add_argument("--dropout-kind", default="iid",
                    choices=("iid", "markov", "cluster"),
                    help="straggler model: i.i.d. per round, bursty "
                         "two-state Markov chains, or whole-cluster "
                         "outages")
    ap.add_argument("--dropout-recover", type=float, default=0.5,
                    help="markov dropout: per-round recovery probability "
                         "(mean outage = 1/recover rounds)")
    ap.add_argument("--plan", default="",
                    help="replay a saved RoundPlan JSON instead of "
                         "planning here")
    ap.add_argument("--plan-out", default="",
                    help="save the executed RoundPlan as JSON")
    ap.add_argument("--quant", default="",
                    choices=["", "int8", "int4", "fp8"],
                    help="quantize client payloads to this storage "
                         "(empty = full-precision wire)")
    ap.add_argument("--quant-block", type=int, default=512,
                    help="values per absmax scale block (int4 needs a "
                         "multiple of 256, others of 128)")
    ap.add_argument("--quant-rounding", default="nearest",
                    choices=["nearest", "stochastic"],
                    help="quantizer rounding mode (stochastic: int "
                         "grids only)")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="drop the round-trip residual instead of "
                         "carrying it into the next round's quantization")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; required to run "
                         "without a GPU, e.g. --device cpu)")
    ap.add_argument("--out", default="")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
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
    quant = None
    if args.quant:
        quant = QuantSpec(storage=args.quant, block=args.quant_block,
                          rounding=args.quant_rounding,
                          error_feedback=not args.no_error_feedback,
                          seed=args.seed)
    server = FederatedServer(network, loss_fn, params, batcher, cfg,
                             algorithm=args.algorithm,
                             execution=ExecutionConfig(
                                 backend=args.backend, scan=args.scan,
                                 record_mixed=args.record_mixed,
                                 quant=quant),
                             device=device)
    if args.controller:
        if args.plan:
            raise SystemExit(
                "--controller generates its own realized plan; it cannot "
                "replay --plan (replay the realized artifact without "
                "--controller instead)")
        if args.dropout > 0:
            raise SystemExit(
                "--controller and --dropout are mutually exclusive: "
                "straggler injection on a controlled run belongs to the "
                "stream runtime's fault specs")
        if args.quant:
            raise SystemExit(
                "--controller does not support --quant (controlled "
                "execution has no error-feedback replay state)")
        history = server.run(eval_fn=eval_fn, controller=args.controller)
        if args.plan_out:
            server.last_plan.save(args.plan_out)
            print(f"realized trajectory saved to {args.plan_out}")
        return _report(args, server, history)
    plan = RoundPlan.load(args.plan) if args.plan else None
    if args.dropout > 0:
        if plan is None:
            plan = {"semidec": RoundPlan.connectivity_aware,
                    "fedavg": RoundPlan.fedavg,
                    "colrel": RoundPlan.colrel}[args.algorithm](network, cfg)
        drop_rng = np.random.default_rng(args.seed + 1)
        if args.dropout_kind == "markov":
            # --dropout is the *marginal* straggler rate for every kind:
            # the stationary chain with recovery p_rec drops a
            # p_fail/(p_fail+p_rec) fraction, so invert for p_fail
            p_rec = args.dropout_recover
            p_fail = min(args.dropout / max(1.0 - args.dropout, 1e-9)
                         * p_rec, 1.0)
            plan = plan.with_markov_dropout(p_fail, p_rec, drop_rng)
        elif args.dropout_kind == "cluster":
            plan = plan.with_cluster_dropout(args.dropout, drop_rng,
                                             partition=network.partition)
        else:
            plan = plan.with_dropout(args.dropout, drop_rng)
    history = server.run(eval_fn=eval_fn, plan=plan)
    if args.plan_out:
        out_plan = server.last_plan
        if quant is not None and out_plan.quant is None:
            # fold the wire format into the artifact so a --plan replay
            # reproduces the quantized run without re-passing the flags
            out_plan = out_plan.with_quant(quant)
        out_plan.save(args.plan_out)
        print(f"trajectory saved to {args.plan_out}")
    return _report(args, server, history)


def _report(args, server, history) -> int:
    rows = []
    for rec in history.records:
        rows.append(dict(t=rec.t, m=rec.m_actual, d2s=rec.d2s, d2d=rec.d2d,
                         **rec.metrics))
        if not args.quiet:
            acc = rec.metrics.get("test_acc", float("nan"))
            print(f"round {rec.t:3d}  m={rec.m_actual:3d} "
                  f"d2d={rec.d2d:4d}  acc={acc:.4f}", flush=True)
    total = history.ledger.total_cost
    print(f"{args.algorithm} on {server.device} ({server.effective_backend}"
          f" backend): total comm cost = {total:.1f} "
          f"(D2S {history.ledger.total_d2s}, "
          f"D2D {history.ledger.total_d2d})")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"algorithm": args.algorithm, "rounds": rows,
                       "total_cost": total}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
