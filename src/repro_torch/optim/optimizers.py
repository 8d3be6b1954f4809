"""Functional optimizers (optax-style ``init``/``update`` pairs; port of
``repro.optim.optimizers``).

The paper's algorithm uses plain SGD for the local steps (eq. 1); Adam/AdamW
are provided for the centralized / server-side training paths of the larger
architectures and for heterogeneous client fleets (``optim.hetero``).  Each
``update`` is a plain function of tensors on the port's pytrees
(``core.pytree.tree_map``), so ``torch.func.grad`` / ``vmap`` trace through
it.  No external optimizer dependency.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.core.pytree import tree_leaves, tree_map

PyTree = Any

__all__ = ["Optimizer", "AdamState", "sgd", "momentum", "adam", "adamw",
           "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, torch.Tensor],
                     Tuple[PyTree, PyTree]]
    # update(grads, state, params, lr) -> (new_params, new_state)


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        new = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
        return new, state

    return Optimizer(init, update)


def momentum(beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, vel, params, lr):
        vel = tree_map(lambda v, g: beta * v + g.to(v.dtype), vel, grads)
        if nesterov:
            step = tree_map(lambda v, g: beta * v + g.to(v.dtype),
                            vel, grads)
        else:
            step = vel
        new = tree_map(lambda p, s: p - lr * s.to(p.dtype), params, step)
        return new, vel

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: PyTree
    nu: PyTree
    count: torch.Tensor


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
        return AdamState(mu=tree_map(f32, params), nu=tree_map(f32, params),
                         count=torch.zeros((), dtype=torch.int32,
                                           device=device))

    def update(grads, state, params, lr):
        count = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(
            g.float()), state.nu, grads)
        # bias corrections in fp32 on the params' device (count lives there)
        bc1 = 1 - b1 ** count.float()
        bc2 = 1 - b2 ** count.float()

        def step(p, m, v):
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype)

        new = tree_map(step, params, mu, nu)
        return new, AdamState(mu=mu, nu=nu, count=count)

    return Optimizer(init, update)


def adamw(lr_decoupled_wd: float = 0.01, **kw) -> Optimizer:
    return adam(weight_decay=lr_decoupled_wd, **kw)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in leaves))
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)
