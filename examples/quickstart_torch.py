"""Quickstart on the PyTorch/CUDA port: 10 rounds of connectivity-aware
semi-decentralized FL (the twin of ``examples/quickstart.py``).

Builds the paper's setup at small scale (n=20 clients, c=2 clusters),
trains a logistic-regression model on a synthetic non-iid dataset with
Algorithm 1 through ``repro_torch``, and prints how the server's
connectivity-aware rule m(t) adapts to the sampled D2D topology each
round.  The D2D network is the ``k_regular`` topology family (the paper's
k-regular digraphs with 10% link failures), built from its declarative
spec.

    PYTHONPATH=src python examples/quickstart_torch.py              # cuda
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse
from functools import partial

import numpy as np
import torch

from repro_torch import topology
from repro_torch.core.server import FederatedServer, ServerConfig
from repro_torch.data import (FederatedBatcher, label_sorted_partition,
                              make_classification)
from repro_torch.fl.engine import ExecutionConfig
from repro_torch.models import cnn as cnn_lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--samples", type=int, default=2000)
    args = ap.parse_args(argv)
    n, clusters, rounds = 20, 2, args.rounds
    device = torch.device(args.device)
    rng = np.random.default_rng(0)

    # 1. data: synthetic 10-class task, label-sorted non-iid partition
    ds = make_classification(n_samples=args.samples)
    parts = label_sorted_partition(ds, n, shards_per_client=2, rng=rng)
    batcher = FederatedBatcher(ds, parts, T=5, batch_size=32)

    # 2. model + mu-strongly-convex loss (Assumption 1)
    params = cnn_lib.init_logreg(seed=0)
    loss_fn = partial(cnn_lib.l2_regularized_loss, cnn_lib.logreg_apply)

    # 3. the time-varying D2D network: k-regular digraphs, 10% link failures
    network = topology.make_spec("k_regular", n=n, c=clusters,
                                 k_range=(6, 9), p_fail=0.1).build()

    # 4. Algorithm 1 with connectivity threshold phi_max; one
    #    ExecutionConfig picks the runtime (packed one-pass kernels, the
    #    whole trajectory from stacked plan columns)
    cfg = ServerConfig(T=5, t_max=rounds, phi_max=2.0)
    server = FederatedServer(network, loss_fn, params, batcher, cfg,
                             algorithm="semidec",
                             execution=ExecutionConfig(backend="fused",
                                                       scan=True),
                             device=device)

    xs = torch.as_tensor(ds.x, device=device)
    ys = torch.as_tensor(ds.y, device=device).long()

    def eval_fn(p):
        return {"acc": cnn_lib.accuracy(cnn_lib.logreg_apply, p, xs, ys)}

    history = server.run(eval_fn=eval_fn)

    print(f"\n{'t':>3} {'m(t)':>5} {'psi bound':>10} {'D2D':>5} {'acc':>7}")
    for r in history.records:
        print(f"{r.t:3d} {r.m_actual:5d} {r.psi_bound:10.3f} "
              f"{r.d2d:5d} {r.metrics['acc']:7.3f}")
    print(f"\ntotal communication cost (D2S + 0.1*D2D): "
          f"{history.ledger.total_cost:.1f}")
    print("note how m(t) tracks the sampled topology: denser clusters ->"
          " smaller m -> fewer expensive uplinks.")

    # the executed trajectory is a pinned artifact: save it and re-run it
    # verbatim later (server.run(plan=RoundPlan.load(path)))
    plan_json = server.last_plan.to_json()
    print(f"\nreproducible trajectory: {len(plan_json)} bytes of JSON "
          f"({server.last_plan.n_rounds} rounds x "
          f"{server.last_plan.n_clients} clients), run on {device} "
          f"({server.effective_backend} backend)")
    return server, history


if __name__ == "__main__":
    main()
