"""The plain reference of ``mcmahan_cnn_paper``: the McMahan et al. CNN
written out (5x5 'SAME' convolutions, ReLU, 2x2 max pooling, the NHWC
flatten the weights' layout states, two dense layers), its loss
(cross-entropy plus mu/2 times the squared norm of every leaf), and
Algorithm 1's rounds over it (``algorithm1``), client by client with
``torch.autograd``: no ``vmap``, no packing, no kernel.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from chipbench.harness import leaves_by_path
from chipbench.reference import algorithm1, plan as plan_ref
from chipbench.reference.precision import compute_dtype, conv2d, mm

__all__ = ["forward", "loss", "follow"]


def forward(P: Dict[str, torch.Tensor], x: torch.Tensor, mode: str,
            pool: int = 2) -> torch.Tensor:
    """x (B, H, W, C) -> logits (B, classes)."""
    h = x.permute(0, 3, 1, 2)
    for name in ("conv1", "conv2"):
        w = P[f"{name}/w"].permute(3, 2, 0, 1)          # HWIO -> OIHW
        h = conv2d(h, w, w.shape[-1] // 2, mode) + \
            P[f"{name}/b"][None, :, None, None]
        h = F.max_pool2d(torch.relu(h), pool)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = torch.relu(mm(h, P["fc1/w"], mode) + P["fc1/b"])
    return mm(h, P["fc2/w"], mode) + P["fc2/b"]


def loss(P, x, y, mu: float, mode: str) -> torch.Tensor:
    logp = torch.log_softmax(forward(P, x, mode), dim=-1)
    ce = -logp.gather(-1, y.long()[:, None]).mean()
    return ce + 0.5 * mu * sum((v * v).sum() for v in P.values())


def follow(inputs: Dict, plan_cols: Dict, batches, device: str,
           precision: str = "fp32") -> Dict:
    """Follow the check block's rounds from the seed's params on the
    same batches (``batches[t]``: the (n, T, B) sample indices of round
    t); returns the plan check and what ``algorithm1.follow_rounds``
    returns."""
    s = inputs["sizes"]
    if str(device).startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    lr0, decay = s["lr0"], s["lr_decay"]
    n_bad, bad, rounds = plan_ref.check_plan(
        plan_cols, s, lambda t: lr0 * decay ** t)
    cdt = compute_dtype(precision)
    x = torch.as_tensor(inputs["x"], device=device).to(cdt)
    y = torch.as_tensor(inputs["y"], device=device).long()
    xt = torch.as_tensor(inputs["x_test"], device=device).to(cdt)
    yt = torch.as_tensor(inputs["y_test"], device=device).long()
    idx = [torch.as_tensor(b, device=device) for b in batches]
    mu = s["l2_mu"]

    def grad_fn(P, batch):
        P = {k: v.detach().requires_grad_(True) for k, v in P.items()}
        value = loss(P, *batch, mu, precision)
        return dict(zip(P, torch.autograd.grad(value, list(P.values()))))

    def eval_loss(P):
        with torch.no_grad():
            return loss({k: v.to(cdt) for k, v in P.items()}, xt, yt, mu,
                        precision)

    init = leaves_by_path(inputs["make_params"](device))
    out = algorithm1.follow_rounds(
        init, rounds, lambda t, i, st: (x[idx[t][i, st]], y[idx[t][i, st]]),
        grad_fn, eval_loss, s["local_steps"], cdt)
    out["plan_violations"] = n_bad
    out["plan_messages"] = bad[:5]
    return out

