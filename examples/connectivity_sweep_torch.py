"""Connectivity structure as the experiment variable: a topology sweep on
the PyTorch/CUDA port (the twin of ``examples/connectivity_sweep.py``).

The paper's trade-off knob is the connectivity-factor threshold phi_max,
but the *structure* generating the connectivity is just as fundamental:
the server's m(t) rule responds to the degree statistics of whatever
graph family the D2D layer happens to be.  This sweep runs Algorithm 1
unchanged across the registered ``repro_torch.topology`` families --
from the paper's dense k-regular clusters (small psi -> few uplinks)
through mobility-driven geometric graphs to the sparse ring / star
extremes (psi near its max -> m(t) pushed back toward full
participation) -- and reports how m(t), the communication cost, and
accuracy respond.

    PYTHONPATH=src python examples/connectivity_sweep_torch.py      # cuda
    PYTHONPATH=src python examples/connectivity_sweep_torch.py \\
        --device cpu --rounds 2 --n 12 --clusters 2 --samples 600
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

# one runtime selection for every sweep point: packed one-pass mixing,
# the whole trajectory from stacked plan columns
EXECUTION = ExecutionConfig(backend="fused", scan=True)

# one representative spec per family (overridden by --families)
DEFAULT_FAMILIES = (
    "k_regular:k_range=6-9,p_fail=0.1",
    "erdos_renyi:p_edge=0.6",
    "geometric:radius=0.35,speed=0.08",
    "small_world:hops=2,beta=0.2",
    "ring:hops=1",
    "hub:hubs=1",
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--n", type=int, default=70)
    ap.add_argument("--clusters", type=int, default=7)
    ap.add_argument("--samples", type=int, default=3500)
    ap.add_argument("--phi-max", type=float, default=0.2)
    ap.add_argument("--families", nargs="*", default=list(DEFAULT_FAMILIES),
                    help="topology specs 'family:key=val,...' to sweep")
    args = ap.parse_args(argv)

    n, clusters, rounds = args.n, args.clusters, args.rounds
    device = torch.device(args.device)
    rng = np.random.default_rng(0)
    ds = make_classification(n_samples=args.samples)
    parts = label_sorted_partition(ds, n, shards_per_client=2, rng=rng)
    batcher = FederatedBatcher(ds, parts, T=5, batch_size=32)
    params = cnn_lib.init_mlp(seed=0)
    loss_fn = partial(cnn_lib.l2_regularized_loss, cnn_lib.mlp_apply)
    xs = torch.as_tensor(ds.x, device=device)
    ys = torch.as_tensor(ds.y, device=device).long()

    def eval_fn(p):
        return {"acc": cnn_lib.accuracy(cnn_lib.mlp_apply, p, xs, ys)}

    print(f"phi_max = {args.phi_max}, device {device}\n")
    print(f"{'family':>12} {'mean psi':>9} {'mean m':>7} {'D2S':>6} "
          f"{'D2D':>7} {'cost':>8} {'final acc':>10}")
    results = {}
    for spec_str in args.families:
        spec = topology.parse_spec(spec_str, n=n, c=clusters)
        network = spec.build()
        cfg = ServerConfig(T=5, t_max=rounds, phi_max=args.phi_max)
        server = FederatedServer(network, loss_fn, params, batcher, cfg,
                                 algorithm="semidec", execution=EXECUTION,
                                 device=device)
        h = server.run(eval_fn=eval_fn, eval_every=max(rounds - 1, 1))
        results[spec.family] = h
        mean_m = float(np.mean([r.m_actual for r in h.records]))
        mean_psi = float(np.mean([r.psi_bound for r in h.records]))
        print(f"{spec.family:>12} {mean_psi:9.3f} {mean_m:7.1f} "
              f"{h.ledger.total_d2s:6d} {h.ledger.total_d2d:7d} "
              f"{h.ledger.total_cost:8.1f} "
              f"{h.records[-1].metrics['acc']:10.3f}")
    print("\ndense, regular families (k_regular, erdos_renyi) keep psi"
          "\nsmall -> the D2D layer carries the aggregation and m(t) drops;"
          "\nsparse/star extremes (ring, hub) blow the degree bounds up ->"
          "\nthe server falls back toward full D2S participation.")
    return results


if __name__ == "__main__":
    main()
