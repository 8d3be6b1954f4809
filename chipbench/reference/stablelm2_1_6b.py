"""The plain reference of ``stablelm2_1_6b``: the decoder written out
(pre-norm LayerNorm blocks, causal softmax attention over 32 heads of 64
with qkv biases and rotary embeddings on the first 25% of each head
(rotate-half pairs, theta 10,000), the SiLU-gated MLP, the final norm
and the untied head, cross-entropy over every position), and Algorithm
1's rounds over it (``algorithm1``), client by client with
``torch.autograd``: no remat, no chunking, no ``vmap``, no kernel.

It computes in the precision the configuration states: params and
activations in bf16 between operations, every product accumulated in
fp32, the norms, the attention scores and softmax, and the loss in
fp32, each SGD step taken in fp32 and stored in bf16 (``precision``
``stated``).  ``fp8`` (the control) rounds every product's operands to
e4m3 first; ``fp32`` computes everything in fp32.

As in the program, the norms have a scale and no bias (the published
model's have both; PERF.md lists the departure).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from chipbench.harness import leaves_by_path
from chipbench.reference import algorithm1, plan as plan_ref
from chipbench.reference.precision import mm

__all__ = ["loss", "follow"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtypes(s: Dict, mode: str):
    """(activation dtype, product mode): the stated dtype with exact
    products (``stated``), the stated dtype with rounded products, or
    fp32."""
    if mode == "fp32":
        return torch.float32, "fp32"
    act = _DTYPES[s["torch_dtype"]]
    return act, ("fp32" if mode == "stated" else mode)


def _layer_norm(x, w, eps, act):
    """In fp32, the result in the activation dtype."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * w.float()).to(act)


def _rotary(x, s, positions):
    """Rotate the first ``partial_rotary_factor`` of each head's dims:
    (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin) on its two halves."""
    hd = x.shape[-1]
    rot = int(hd * s["partial_rotary_factor"])
    rot -= rot % 2
    half = rot // 2
    inv = 1.0 / (float(s["rope_theta"]) ** (
        torch.arange(half, device=x.device, dtype=torch.float32) / half))
    ang = positions.float()[:, None] * inv[None, :]           # (S, half)
    cos = torch.cos(ang)[:, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, None, :].to(x.dtype)
    x1, x2, rest = x[..., :half], x[..., half:rot], x[..., rot:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], -1)


def loss(P: Dict[str, torch.Tensor], tokens, targets, s: Dict,
         mode: str = "stated") -> torch.Tensor:
    """Mean next-token cross-entropy of (B, S) ``tokens`` against
    ``targets`` under params ``P`` (leaves by path, in the activation
    dtype)."""
    act, prod = _dtypes(s, mode)

    def lin(a, w):
        return mm(a, w, prod).to(act)

    B, S = tokens.shape
    H, Hkv = s["num_attention_heads"], s["num_key_value_heads"]
    d = s["hidden_size"]
    hd, eps = d // H, s["layer_norm_eps"]
    pos = torch.arange(S, device=tokens.device)
    causal = torch.ones(S, S, dtype=torch.bool, device=tokens.device).tril()
    x = P["embed"][tokens.long()]
    lay = "decoder/layers/"
    for l in range(s["num_hidden_layers"]):
        h = _layer_norm(x, P[lay + "ln1"][l], eps, act)

        def proj(name):
            y = lin(h, P[f"{lay}attn/{name}/w"][l])
            b = P.get(f"{lay}attn/{name}/b")
            return y if b is None else y + b[l]

        q = _rotary(proj("q").reshape(B, S, H, hd), s, pos)
        k = _rotary(proj("k").reshape(B, S, Hkv, hd), s, pos)
        v = proj("v").reshape(B, S, Hkv, hd)
        if Hkv != H:
            k = k.repeat_interleave(H // Hkv, dim=2)
            v = v.repeat_interleave(H // Hkv, dim=2)
        q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        scores = mm(q.float(), k.float().transpose(-1, -2), prod) * \
            hd ** -0.5
        w = torch.softmax(scores.masked_fill(~causal, float("-inf")),
                          -1).to(act)
        del scores
        att = lin(w, v).permute(0, 2, 1, 3).reshape(B, S, H * hd)
        x = x + lin(att, P[lay + "attn/o/w"][l])
        h = _layer_norm(x, P[lay + "ln2"][l], eps, act)
        gate = lin(h, P[lay + "mlp/gate"][l])
        up = lin(h, P[lay + "mlp/up"][l])
        x = x + lin(torch.nn.functional.silu(gate) * up,
                    P[lay + "mlp/down"][l])
    h = _layer_norm(x, P["final_norm"], eps, act)
    logits = mm(h, P["lm_head"], prod).float()
    logp = torch.log_softmax(logits, -1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


def follow(inputs: Dict, plan_cols: Dict, batches, device: str,
           precision: str = "stated") -> Dict:
    """Follow the check block's rounds from the seed's params on the
    same token rows (``batches[t]``: (n, T, B, S + 1) ids of round t)."""
    s = inputs["sizes"]
    if str(device).startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction = False
    act, _ = _dtypes(s, precision)
    lr = s["lr"]
    n_bad, bad, rounds = plan_ref.check_plan(plan_cols, s, lambda t: lr)
    toks = [torch.as_tensor(np.asarray(b), device=device) for b in batches]
    ev = torch.as_tensor(inputs["eval_tokens"], device=device)

    def grad_fn(P, batch):
        P = {k: v.detach().requires_grad_(True) for k, v in P.items()}
        value = loss(P, batch[:, :-1], batch[:, 1:], s, precision)
        grads = torch.autograd.grad(value, list(P.values()))
        return dict(zip(P, grads))

    def eval_loss(P):
        with torch.no_grad():
            return loss({k: v.to(act) for k, v in P.items()}, ev[:, :-1],
                        ev[:, 1:], s, precision)

    init = leaves_by_path(inputs["make_params"](device))
    out = algorithm1.follow_rounds(init, rounds,
                                   lambda t, i, st: toks[t][i, st],
                                   grad_fn, eval_loss, s["local_steps"], act)
    out["plan_violations"] = n_bad
    out["plan_messages"] = bad[:5]
    return out

