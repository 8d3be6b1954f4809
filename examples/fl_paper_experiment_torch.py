"""The paper's Sec. 6 experiment on the PyTorch/CUDA port (the twin of
``examples/fl_paper_experiment.py``): communication cost against testing
accuracy, Figs. 2-5.

n=70 clients, c=7 clusters, the paper's CNN (1.66M params, 2x conv5x5 +
maxpool), label-sorted non-iid split (2 label chunks/client), T=5 local SGD
steps -- comparing Algorithm 1 (connectivity-aware m(t)) against FedAvg and
COLREL under the paper's two D2S regimes:

  high D2S connectivity: p=0.1, phi_max=0.06, FedAvg m=57, COLREL m=52
  low  D2S connectivity: p=0.2, phi_max=0.20, FedAvg m=26, COLREL m=15

Cost model: (#D2S) + 0.1 x (#D2D) (paper Sec. 6.2).  Five runs a case:
Algorithm 1 with degree-only bounds, with the exact-sigma oracle, and with
int8 + error-feedback quantized uplink payloads (block 128, the
``aggregate`` backend: one ``aggregate_dequant`` kernel launch a round on
a GPU), then FedAvg and COLREL.  Every row also reports byte-weighted
uplink spend (``uplink_bytes`` / ``uplink_bytes_per_acc``) at its wire
width.  ``run`` is the experiment of ``benchmarks/comm_cost.py``, kept
here so the port needs nothing of the JAX package.

    PYTHONPATH=src python examples/fl_paper_experiment_torch.py     # cuda
    PYTHONPATH=src python examples/fl_paper_experiment_torch.py \\
        --device cpu --model mlp --rounds 2
"""

import argparse
from functools import partial
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch import topology
from repro_torch.core.pytree import tree_map
from repro_torch.core.server import FederatedServer, ServerConfig
from repro_torch.data import (FederatedBatcher, label_sorted_partition,
                              make_classification)
from repro_torch.fl import packing
from repro_torch.fl.engine import ExecutionConfig
from repro_torch.fl.packing import QuantSpec
from repro_torch.models import cnn as cnn_lib

__all__ = ["CASES", "experiment", "run", "main"]

CASES = {
    "high": dict(p=0.1, phi_max=0.06, m_fedavg=57, m_colrel=52),
    "low": dict(p=0.2, phi_max=0.20, m_fedavg=26, m_colrel=15),
}

MODELS = {"cnn": (cnn_lib.init_cnn, cnn_lib.cnn_apply),
          "mlp": (cnn_lib.init_mlp, cnn_lib.mlp_apply),
          "logreg": (cnn_lib.init_logreg, cnn_lib.logreg_apply)}


def _cost_at_accuracy(history, target: float):
    """(cost, round) at which test_acc first reaches target (nan if never)."""
    cost = history.cumulative_cost()
    for rec, c in zip(history.records, cost):
        if rec.metrics.get("test_acc", 0.0) >= target:
            return float(c), rec.t
    return float("nan"), -1


def experiment(case: str = "high", rounds: int = 15, model: str = "mlp",
               n: int = 70, clusters: int = 7, seed: int = 0, T: int = 5,
               batch: int = 16, samples: int = 7000, noise: float = 1.5,
               lr0: float = 0.05, device="cuda") -> SimpleNamespace:
    """One case's setting: the data, the model, its loss, ``eval_fn`` (test
    accuracy on ``device``), the run's int8 ``QuantSpec`` and
    ``make_server(algorithm, m_fixed=None, bound_kind='auto', quant=None,
    backend='aggregate')``, which builds one run's ``FederatedServer``.
    A quantized run takes ``backend`` ('einsum' gives its oracle)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this experiment runs on the "
                           "GPU by default; pass --device cpu (device="
                           "'cpu') to run it on the CPU")
    cfg_case = CASES[case]
    rng = np.random.default_rng(seed)
    ds_train = make_classification(n_samples=samples, noise=noise,
                                   seed=seed)
    ds_test = make_classification(n_samples=samples // 4, noise=noise,
                                  seed=seed + 1)
    parts = label_sorted_partition(ds_train, n, shards_per_client=2, rng=rng)
    batcher = FederatedBatcher(ds_train, parts, T=T, batch_size=batch)

    init_fn, apply_fn = MODELS.get(model, MODELS["logreg"])
    params0 = init_fn(seed)
    loss_fn = partial(cnn_lib.l2_regularized_loss, apply_fn)
    xs = torch.as_tensor(ds_test.x, device=device)
    ys = torch.as_tensor(ds_test.y, device=device).long()

    def eval_fn(p):
        return {"test_acc": cnn_lib.accuracy(apply_fn, p, xs, ys)}

    def make_server(algorithm, m_fixed=None, bound_kind="auto", quant=None,
                    backend="aggregate"):
        network = topology.make_spec("k_regular", n=n, c=clusters,
                                     k_range=(6, 9),
                                     p_fail=cfg_case["p"]).build()
        # deviation from the paper's printed 0.02*0.1^t (which zeroes the
        # step after ~2 rounds): same lr0, gentler decay -- see DESIGN §8.
        sc = ServerConfig(T=T, t_max=rounds, phi_max=cfg_case["phi_max"],
                          m_fixed=m_fixed, seed=seed,
                          bound_kind=bound_kind,
                          eta=lambda t: lr0 * (0.9 ** t))
        execution = None
        if quant is not None:
            execution = ExecutionConfig(backend=backend, quant=quant)
        return FederatedServer(network, loss_fn, params0, batcher, sc,
                               algorithm=algorithm, execution=execution,
                               device=device)

    int8 = QuantSpec(storage="int8", block=128, error_feedback=True,
                     seed=seed)
    return SimpleNamespace(case=case, params0=params0, loss_fn=loss_fn,
                           eval_fn=eval_fn, make_server=make_server,
                           int8=int8)


def run(case: str = "high", rounds: int = 15, model: str = "mlp",
        n: int = 70, clusters: int = 7, seed: int = 0, T: int = 5,
        batch: int = 16, samples: int = 7000, noise: float = 1.5,
        lr0: float = 0.05, quiet: bool = False, device="cuda"):
    exp = experiment(case, rounds, model, n, clusters, seed, T, batch,
                     samples, noise, lr0, device)
    cfg_case, int8 = CASES[case], exp.int8
    runs = {
        # degree-only bounds (what the deployed server can compute) and the
        # exact-sigma oracle (the regime the paper's figures operate in);
        # semidec-int8 reruns Algorithm 1 with quantized uplink payloads
        # so byte-weighted cost-per-accuracy lands next to the message-
        # count model
        "semidec": exp.make_server("semidec").run(exp.eval_fn),
        "semidec-exact": exp.make_server(
            "semidec", bound_kind="exact").run(exp.eval_fn),
        "semidec-int8": exp.make_server("semidec",
                                        quant=int8).run(exp.eval_fn),
        "fedavg": exp.make_server("fedavg",
                                  cfg_case["m_fedavg"]).run(exp.eval_fn),
        "colrel": exp.make_server("colrel",
                                  cfg_case["m_colrel"]).run(exp.eval_fn),
    }
    # per-upload payload bytes on the packed wire (fp32 vs int8+scales),
    # from shapes alone
    quants = {"semidec-int8": int8}
    shape_tree = tree_map(
        lambda p: torch.empty((1,) + tuple(p.shape), dtype=p.dtype,
                              device="meta"), exp.params0)
    payload_bytes = {
        name: (packing.pack_spec(shape_tree, quant=q).quantized_nbytes(1)
               if (q := quants.get(name)) is not None
               else packing.pack_spec(shape_tree).nbytes(1))
        for name in runs}

    final_accs = {k: h.records[-1].metrics["test_acc"]
                  for k, h in runs.items()}
    target = min(final_accs.values()) * 0.98     # matched-accuracy level
    rows = []
    for name, h in runs.items():
        cost_at, round_at = _cost_at_accuracy(h, target)
        pb = int(payload_bytes[name])
        up = int(h.ledger.total_d2s) * pb
        acc = final_accs[name]
        rows.append(dict(
            algorithm=name, case=case,
            final_acc=acc,
            total_cost=float(h.ledger.total_cost),
            total_d2s=h.ledger.total_d2s,
            total_d2d=h.ledger.total_d2d,
            cost_at_matched_acc=cost_at,
            rounds_to_matched_acc=round_at,
            mean_m=float(np.mean([r.m_actual for r in h.records])),
            payload_bytes_per_upload=pb,
            uplink_bytes=up,
            uplink_bytes_per_acc=float(up / max(acc, 1e-9)),
        ))
        if not quiet:
            r = rows[-1]
            print(f"[{case}] {name:14s} acc={r['final_acc']:.3f} "
                  f"cost={r['total_cost']:8.1f} "
                  f"cost@acc>={target:.2f}: {r['cost_at_matched_acc']:8.1f} "
                  f"mean m={r['mean_m']:.1f} "
                  f"up={up/1e6:7.2f}MB ({up/max(acc,1e-9)/1e6:6.2f}MB/acc)")
    if not quiet:
        for base in ("fedavg", "colrel"):
            bl = next(r for r in rows if r["algorithm"] == base)
            for which in ("semidec", "semidec-exact"):
                sd = next(r for r in rows if r["algorithm"] == which)
                if np.isfinite(sd["cost_at_matched_acc"]) and \
                        np.isfinite(bl["cost_at_matched_acc"]):
                    sav = 1 - (sd["cost_at_matched_acc"]
                               / bl["cost_at_matched_acc"])
                    print(f"[{case}] {which} saves {100 * sav:.0f}% of "
                          f"{base}'s cost at matched accuracy")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--model", default="cnn", choices=("cnn", "mlp"))
    ap.add_argument("--case", default="high", choices=("high", "low"))
    args = ap.parse_args(argv)

    rows = run(case=args.case, rounds=args.rounds, model=args.model,
               device=args.device)
    semidec = next(r for r in rows if r["algorithm"] == "semidec")
    fedavg = next(r for r in rows if r["algorithm"] == "fedavg")
    colrel = next(r for r in rows if r["algorithm"] == "colrel")
    print("\nsummary (validates the paper's qualitative claim):")
    print(f"  Algorithm 1 total cost {semidec['total_cost']:.0f} vs "
          f"FedAvg {fedavg['total_cost']:.0f} vs "
          f"COLREL {colrel['total_cost']:.0f}")
    return rows


if __name__ == "__main__":
    main()
