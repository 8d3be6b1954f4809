"""The paper's own model (Sec. 6.1.3): the McMahan et al. CNN.

Two 5x5 conv layers (32 then 64 channels), each followed by 2x2 max pooling,
then a 512-unit dense layer and a 10-way softmax head (1,663,370
parameters at 28x28x1).  A small MLP and a multinomial logistic regression
head are included for the strongly-convex validation experiments.

Params are dicts of tensors in the reference's layout -- conv kernels HWIO,
dense kernels (in, out), inputs NHWC -- and init draws the same numpy
stream (``default_rng(seed)``), so a model here and in ``repro`` starts
from identical weights and packs into identical buffers.  ``cnn_apply``
runs ``torch`` convolutions in NCHW/OIHW and permutes the activations back
to NHWC before the flatten, so ``fc1`` sees the reference's feature order.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.pytree import tree_leaves

PyTree = Any

__all__ = ["init_cnn", "cnn_apply", "init_mlp", "mlp_apply",
           "init_logreg", "logreg_apply", "softmax_xent", "accuracy",
           "l2_regularized_loss"]


def _he(rng, shape, fan_in):
    return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(
        np.float32)


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a, device=device)


def _zeros(k: int, device) -> torch.Tensor:
    return torch.zeros(k, dtype=torch.float32, device=device)


def init_cnn(seed: int = 0, n_classes: int = 10, image_hw: int = 28,
             channels: int = 1, device: Optional[str] = None) -> PyTree:
    rng = np.random.default_rng(seed)
    hw4 = image_hw // 4
    return {
        "conv1": {"w": _t(_he(rng, (5, 5, channels, 32), 25 * channels),
                          device),
                  "b": _zeros(32, device)},
        "conv2": {"w": _t(_he(rng, (5, 5, 32, 64), 25 * 32), device),
                  "b": _zeros(64, device)},
        "fc1": {"w": _t(_he(rng, (hw4 * hw4 * 64, 512), hw4 * hw4 * 64),
                        device),
                "b": _zeros(512, device)},
        "fc2": {"w": _t(_he(rng, (512, n_classes), 512), device),
                "b": _zeros(n_classes, device)},
    }


def _conv_nchw(x: torch.Tensor, w_hwio: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    """'SAME' 5x5 convolution: x NCHW, kernel HWIO -> NCHW."""
    w = w_hwio.permute(3, 2, 0, 1)                # HWIO -> OIHW
    return F.conv2d(x, w, padding=w.shape[-1] // 2) + b[None, :, None, None]


def cnn_apply(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) -> logits (B, n_classes)."""
    h = x.permute(0, 3, 1, 2)                     # NHWC -> NCHW
    h = F.max_pool2d(F.relu(_conv_nchw(h, params["conv1"]["w"],
                                       params["conv1"]["b"])), 2)
    h = F.max_pool2d(F.relu(_conv_nchw(h, params["conv2"]["w"],
                                       params["conv2"]["b"])), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC flatten
    h = F.relu(h @ params["fc1"]["w"] + params["fc1"]["b"])
    return h @ params["fc2"]["w"] + params["fc2"]["b"]


def init_mlp(seed: int = 0, d_in: int = 784, d_hidden: int = 64,
             n_classes: int = 10, device: Optional[str] = None) -> PyTree:
    rng = np.random.default_rng(seed)
    return {
        "fc1": {"w": _t(_he(rng, (d_in, d_hidden), d_in), device),
                "b": _zeros(d_hidden, device)},
        "fc2": {"w": _t(_he(rng, (d_hidden, n_classes), d_hidden), device),
                "b": _zeros(n_classes, device)},
    }


def mlp_apply(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    h = x.reshape(x.shape[0], -1)
    h = F.relu(h @ params["fc1"]["w"] + params["fc1"]["b"])
    return h @ params["fc2"]["w"] + params["fc2"]["b"]


def init_logreg(seed: int = 0, d_in: int = 784, n_classes: int = 10,
                device: Optional[str] = None) -> PyTree:
    rng = np.random.default_rng(seed)
    return {"w": _t(_he(rng, (d_in, n_classes), d_in) * 0.1, device),
            "b": _zeros(n_classes, device)}


def logreg_apply(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1) @ params["w"] + params["b"]


# ---------------------------------------------------------------------------
# Losses / metrics
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None].long()).mean()


def l2_regularized_loss(apply_fn, params: PyTree, batch, mu: float = 1e-2
                        ) -> torch.Tensor:
    """mu-strongly-convex loss (cross-entropy + (mu/2)||params||^2), the
    L2 sum taken over the leaves in the reference's (sorted-key) order."""
    x, y = batch
    ce = softmax_xent(apply_fn(params, x), y)
    sq = sum(torch.sum(torch.square(p)) for p in tree_leaves(params))
    return ce + 0.5 * mu * sq


def accuracy(apply_fn, params: PyTree, x: torch.Tensor, y: torch.Tensor,
             batch: int = 512) -> float:
    hits = 0
    with torch.no_grad():
        for i in range(0, len(y), batch):
            logits = apply_fn(params, x[i:i + batch])
            hits += int((logits.argmax(-1) == y[i:i + batch]).sum())
    return hits / len(y)
