"""Rematerialisation under ``torch.func``: ``remat(body, params, *xs)``
runs ``body`` and, in the backward pass, recomputes it from its inputs
instead of keeping its activations -- the reference's ``jax.checkpoint``
(``repro.models.blocks``), which ``cfg.remat`` applies to each stacked
layer's body and zamba2's group body.  The port also recomputes each
chunk of the chunked loss under ``cfg.remat``, and each query chunk of
chunked attention on its plain route (the CPU, fp32, head dims over
128), so that a layer's backward holds one chunk's fp32 scores, not all
of them; on the card in bf16 chunked attention runs the flash kernels,
which keep no scores to recompute.

``torch.utils.checkpoint`` does not compose with ``torch.func.grad`` /
``vmap`` (its saved-tensor hooks and its legacy ``Function`` both
raise); ``_Remat`` is an ``autograd.Function`` with ``setup_context``
and ``generate_vmap_rule``, whose backward recomputes through
``torch.func.vjp``.  Values and gradients are bitwise those without
remat; first derivatives only.

Under tensor parallelism (``models.sharding``) a rematerialised layer
runs its collectives again in the backward pass: the recomputation
repeats its forward ``all_reduce``s and the vjp runs the backward ones
of its ``copy_to_model``s.  So every rank of a model group must
recompute the same layers in the same order, or the ranks wait on each
other for ever.  They do, since every rank runs the same program on its
own shards (``tests/test_torch_tp.py`` takes gradients on two ranks with
``remat`` on).
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.core.pytree import tree_flatten, tree_unflatten

PyTree = Any

__all__ = ["remat"]


class _Remat(torch.autograd.Function):
    """``outs = fn(*tensors)`` whose backward recomputes ``fn`` through
    ``torch.func.vjp`` from the saved inputs, so no activation of the
    body outlives its forward.  ``setup_context`` and
    ``generate_vmap_rule`` let it compose with ``torch.func.grad`` and
    ``vmap`` (``torch.utils.checkpoint`` does not: its saved-tensor hooks
    and its legacy ``Function`` both raise under ``torch.func``).  Inputs
    that are not floating point (positions) get no gradient."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *tensors):
        return fn(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        diff = [i for i, t in enumerate(saved) if t.is_floating_point()]

        def of_diff(*d):
            args = list(saved)
            for i, t in zip(diff, d):
                args[i] = t
            return ctx.fn(*args)

        # torch.func.grad differentiates with create_graph=True, which
        # would record the recomputation for a second derivative and keep
        # every body's recomputation alive until the whole backward ends.
        # So the recomputation runs under no_grad (vjp's own level ignores
        # it) and the grads are detached: first derivatives only.  The
        # vjp itself runs in grad mode, as the outer backward does: some
        # backward formulas round differently without it.
        with torch.no_grad():
            _, vjp_fn = torch.func.vjp(of_diff, *(saved[i] for i in diff))
        in_grads = [g.detach() for g in vjp_fn(grads)]
        del vjp_fn
        out = [None] * len(saved)
        for i, g in zip(diff, in_grads):
            out[i] = g
        return (None, *out)


def remat(body: Callable[..., Tuple[torch.Tensor, ...]], params: PyTree,
          *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``body(params, *xs)`` -- a tuple of tensors -- rematerialised in
    the backward pass.  Every tensor the body reads must come in through
    ``params`` or ``xs`` (under ``vmap`` a closed-over tensor cannot
    cross the ``Function``); ``xs`` that are not floating point (the
    positions) get no gradient."""
    leaves, treedef = tree_flatten(params)
    n_x = len(xs)

    def fn(*tensors):
        return body(tree_unflatten(treedef, list(tensors[n_x:])),
                    *tensors[:n_x])

    return _Remat.apply(fn, *xs, *leaves)
