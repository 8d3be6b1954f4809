"""Carry parameter pytrees between the JAX reference and the port through
numpy: a JAX param tree (its leaves as numpy arrays, e.g. after
``jax.tree.map(np.asarray, params)``) becomes a tree of tensors on a
device and back, so both packages compute from the same weights."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.pytree import tree_map

PyTree = Any

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(tree: PyTree, device=None) -> PyTree:
    """numpy-leaf tree -> tensor tree (same structure and dtypes; bf16
    arrays arrive as ``ml_dtypes`` bfloat16 and are carried bit for bit)."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).astype(np.int16)) \
                .view(torch.bfloat16).to(device)
        return torch.as_tensor(np.array(a), device=device)

    return tree_map(one, tree)


def params_to_numpy(params: PyTree) -> PyTree:
    """Tensor tree -> numpy-leaf tree on the host (bf16 leaves as float32,
    which holds every bf16 value exactly)."""
    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(one, params)
