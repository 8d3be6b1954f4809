"""Algorithm 1's rounds, plainly (paper eqs. 1-4).

Each client starts from the global params and takes T SGD steps on its
own batches (eq. 1): the gradient from the params in ``compute`` (the
configuration's dtype, or float64 for an fp64 reference), the step
taken in at least float32 and stored at the configuration's dtype; its
delta is its final params less the global ones.  Each sampled
client's mixed delta is the A_t-weighted sum of its cluster's deltas
(eqs. 2-3), and the server adds their sum over m_t (eq. 4).  The mixing
and the sum run in float64, leaf by leaf.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

__all__ = ["follow_rounds"]


def _norms(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
    return {k: float((a[k].double() - b[k].double()).norm()) for k in b}


def follow_rounds(init: Dict[str, torch.Tensor], rounds: List[Dict],
                  client_batch: Callable[[int, int, int], object],
                  grad_fn: Callable[[Dict[str, torch.Tensor], object],
                                    Dict[str, torch.Tensor]],
                  eval_loss: Callable[[Dict[str, torch.Tensor]], float],
                  T: int, compute: torch.dtype = torch.float32) -> Dict:
    """``init``: leaves by path at the stored dtype; ``rounds``: the
    plan's rows as the reference worked them out (``plan.check_plan``);
    ``client_batch(t, i, s)``: client i's batch of step s in round t;
    ``grad_fn(params, batch)``: the loss's gradient by leaf, from params
    in ``compute``.  Returns each round's eval loss and, by leaf, the
    norm of the change from ``init`` after the first round and after the
    last."""
    g = {k: v.clone() for k, v in init.items()}
    step = torch.promote_types(compute, torch.float32)
    out = {"loss": [], "first": None, "final": None}
    for t, r in enumerate(rounds):
        n = len(r["tau"])
        deltas = []
        for i in range(n):
            p = {k: v.clone() for k, v in g.items()}
            for s in range(T):
                grads = grad_fn({k: v.to(compute) for k, v in p.items()},
                                client_batch(t, i, s))
                p = {k: (p[k].to(step) - r["eta"] * grads[k].to(step)).to(
                    p[k].dtype) for k in p}
                del grads
            deltas.append({k: p[k].to(step) - g[k].to(step) for k in g})
            del p
        sampled = [i for i in range(n) if r["tau"][i] == 1.0]
        new = {}
        for k in g:
            agg = torch.zeros(g[k].shape, dtype=torch.float64,
                              device=g[k].device)
            for i in sampled:                       # eq. 4 over eq. 3
                for j in range(n):
                    if r["A"][i, j] != 0.0:
                        agg += float(r["A"][i, j]) * deltas[j][k].double()
            new[k] = (g[k].double() + agg / r["m"]).to(g[k].dtype)
            del agg
        del deltas
        g = new
        out["loss"].append(float(eval_loss(g)))
        if t == 0:
            out["first"] = _norms(g, init)
        if t == len(rounds) - 1:
            out["final"] = _norms(g, init)
    return out
