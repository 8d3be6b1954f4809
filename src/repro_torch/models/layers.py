"""Shared neural building blocks: norms, RoPE, MLPs, initializers (port
of ``repro.models.layers``).

Functions on tensors, in the reference's layouts and dtype order: the
norms compute in fp32 and cast back, RoPE casts cos/sin to ``x.dtype``
before its products, and the GELU MLP uses the tanh approximation, as
``jax.nn.gelu`` does by default.  Initializers take an explicit
``torch.Generator``, which lives on the device the parameters are made
on; they draw other numbers than ``jax.random`` from the same seed, so
the tests carry the reference's parameters across
(``models.convert.params_from_numpy``).  ``mlp_apply`` runs a
tensor-parallel shard too (``models.sharding``), on the whole sequence or
on the rank's rows of it (sequence parallelism); ``mlp_apply_sp`` is the
reference's explicit SP-MLP; ``rms_norm_split`` normalises a width split
over the model group.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from . import sharding

PyTree = Any

__all__ = ["rms_norm", "rms_norm_split", "layer_norm", "norm",
           "rope_angles", "apply_rope", "mlp_init", "mlp_apply",
           "mlp_apply_sp", "dense_init", "he_normal", "lecun_normal"]


# ---------------------------------------------------------------------------
# Initializers (explicit generator; used by model.init)
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


# in place: one fp32 draw alive at a time (an expert stack of deepseek-v2
# is 5 GB in fp32)

def lecun_normal(gen: torch.Generator, shape, dtype=torch.float32):
    fan_in = shape[0] if len(shape) >= 1 else 1
    return _normal(gen, shape).div_(math.sqrt(fan_in)).to(dtype)


def he_normal(gen: torch.Generator, shape, dtype=torch.float32):
    fan_in = shape[0] if len(shape) >= 1 else 1
    return _normal(gen, shape).mul_(math.sqrt(2.0 / fan_in)).to(dtype)


def dense_init(gen: torch.Generator, d_in, d_out, dtype=torch.float32,
               bias=False):
    p = {"w": lecun_normal(gen, (d_in, d_out), dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


def rms_norm_split(x: torch.Tensor, scale: torch.Tensor, whole: int,
                   eps: float = 1e-6):
    """RMSNorm over a width of ``whole`` of which ``x`` holds the rank's
    slice (``scale`` its slice too): the local sum of squares, summed over
    the model group both ways (``sharding.all_reduce_both``: every rank's
    loss reads the whole sum), then the whole width's mean."""
    x32 = x.float()
    ss = sharding.all_reduce_both(x32.square().sum(-1, keepdim=True))
    return ((x32 * torch.rsqrt(ss / whole + eps)) * scale.float()
            ).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return (((x32 - mean) * torch.rsqrt(var + eps)) * scale.float()
            ).to(x.dtype)


def norm(x, scale, kind: str = "rms", eps: float = 1e-6):
    return rms_norm(x, scale, eps) if kind == "rms" else layer_norm(x, scale,
                                                                    eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, dim: int, theta: float = 10_000.0):
    """positions (...,) -> (cos, sin) of shape (..., dim//2), fp32."""
    half = dim // 2
    exponents = torch.arange(half, dtype=torch.float32,
                             device=positions.device) / half
    freqs = 1.0 / (theta ** exponents)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               fraction: float = 1.0) -> torch.Tensor:
    """Rotate the first ``fraction`` of the head dim.

    x: (..., seq, heads, head_dim); cos/sin: (seq, rot_dim//2) broadcast.
    Pairs are (x[..., :half], x[..., half:rot]) -- the "rotate_half" layout
    used by the LLaMA/Qwen family.
    """
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    x1, x2 = xr[..., :half], xr[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    return torch.cat([out1, out2, xp], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             kind: str = "swiglu", dtype=torch.float32) -> PyTree:
    if kind == "swiglu":
        return {"gate": lecun_normal(gen, (d_model, d_ff), dtype),
                "up": lecun_normal(gen, (d_model, d_ff), dtype),
                "down": lecun_normal(gen, (d_ff, d_model), dtype)}
    return {"up": lecun_normal(gen, (d_model, d_ff), dtype),
            "down": lecun_normal(gen, (d_ff, d_model), dtype)}


def mlp_apply(p: PyTree, x: torch.Tensor, kind: str = "swiglu",
              d_ff: int = 0, seq: bool = False) -> torch.Tensor:
    """``d_ff``: the whole ffn width.  Where ``p`` holds less (a
    tensor-parallel shard: ``gate`` / ``up`` split by columns, ``down`` by
    rows), ``x`` enters through ``copy_to_model`` and the output leaves
    through ``reduce_from_model``; with ``seq`` (sequence parallelism:
    ``x`` the rank's rows) through ``gather_seq`` / ``scatter_seq``, and a
    whole MLP runs on the gathered rows and keeps the rank's."""
    split = bool(d_ff) and sharding.holds_shard(p["down"].shape[0], d_ff)
    x = sharding.enter(x, split, seq)
    if kind == "swiglu":
        h = F.silu(x @ p["gate"]) * (x @ p["up"])
    else:
        h = F.gelu(x @ p["up"], approximate="tanh")
    return sharding.leave(h @ p["down"], split, seq)


def mlp_apply_sp(p: PyTree, x: torch.Tensor, kind: str = "swiglu",
                 axis: str = "model", d_ff: int = 0) -> torch.Tensor:
    """The explicit sequence-parallel MLP (the reference's
    ``mlp_apply_sp``): ``x`` the rank's rows of the sequence, gathered
    (``gather_seq``), through the rank's ffn columns, reduce-scattered back
    to its rows (``scatter_seq``).  SwiGLU only."""
    if kind != "swiglu":
        raise ValueError("mlp_apply_sp supports swiglu only")
    if axis != "model":
        raise ValueError(f"the SP-MLP runs over the 'model' axis, not "
                         f"{axis!r}")
    return mlp_apply(p, x, kind, d_ff, seq=True)
