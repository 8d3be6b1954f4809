"""Grouped-query attention: full-sequence, prefill, and cached decode (port
of ``repro.models.attention``).

Supports the dense-family options: GQA (n_kv < n_heads), qk-norm
(qwen3), qkv-bias (qwen1.5/qwen2/internvl2), partial rotary (stablelm-2),
and sliding-window attention (the KV cache becomes a ring buffer of the
window size, so memory is O(window), not O(context)).

The full-sequence path can route through the hand-written CUDA
flash-attention kernels (``cfg.attn_impl == 'flash'``), forward and
backward, so training can take it too; the plain path below is their
oracle.  ``'chunked'`` takes the same kernels wherever they apply -- bf16
on the card at a head dim up to 128, what its input shows -- and keeps
the plain query-chunk loop elsewhere (the CPU, fp32, wider heads): the
kernels hold O(S * tile) state, so the chunk's memory contract holds
either way.  Decode writes the new token's K/V into the cache in place
(the cache leaves are views of the stacked cache) and returns it.

Tensor parallelism (``models.sharding``): a rank may hold whole heads of
q / k / v (column slices, with their biases) and the matching rows of
``o``.  The head counts come from the local weights' widths, so GQA
groups the rank's heads, flash runs on them unchanged, the KV cache holds
them, and ``o``'s partial sums leave through ``reduce_from_model``.
With ``seq`` (sequence parallelism) the full-sequence paths take the
rank's rows of the sequence and return its rows: the input is gathered
(``sharding.enter``) and the output reduce-scattered, or, for attention
that runs whole, cut to the rank's rows (``sharding.leave``).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS
from .config import ModelConfig
from .layers import apply_rope, dense_init, rms_norm, rope_angles
from . import sharding
from .remat import remat

PyTree = Any

__all__ = ["attn_init", "attention_full", "attention_prefill",
           "attention_decode", "make_kv_cache", "local_heads", "NEG_INF"]

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> PyTree:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "q": dense_init(gen, d, nq * hd, dtype, bias=cfg.qkv_bias),
        "k": dense_init(gen, d, nkv * hd, dtype, bias=cfg.qkv_bias),
        "v": dense_init(gen, d, nkv * hd, dtype, bias=cfg.qkv_bias),
        "o": dense_init(gen, nq * hd, d, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
    return p


def local_heads(cfg: ModelConfig) -> Tuple[int, int]:
    """(q heads, kv heads) a rank of the current model group holds: the
    whole counts unless both split into whole heads
    (``sharding.whole_heads``)."""
    _, m = sharding.model_rank()
    if m > 1 and sharding.whole_heads(cfg, m):
        return cfg.n_heads // m, cfg.n_kv_heads // m
    return cfg.n_heads, cfg.n_kv_heads


def _split(cfg: ModelConfig, p: PyTree) -> bool:
    """Whether ``p`` holds a tensor-parallel slice of the heads."""
    return sharding.holds_shard(p["q"]["w"].shape[-1],
                                cfg.n_heads * cfg.resolved_head_dim)


def _project_qkv(cfg: ModelConfig, p: PyTree, x: torch.Tensor,
                 positions: torch.Tensor):
    """x (B,S,D), positions (S,) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd), the
    head counts those of the (local) weights."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim

    def proj(pp):
        y = x @ pp["w"]
        if "b" in pp:
            y = y + pp["b"]
        return y.reshape(B, S, -1, hd)

    q = proj(p["q"])
    k = proj(p["k"])
    v = proj(p["v"])
    if cfg.qk_norm:
        # per-head scales, replicated: each rank's part of their gradient
        # covers its own heads
        split = _split(cfg, p)
        qn, kn = p["q_norm"], p["k_norm"]
        if split:
            qn, kn = sharding.copy_to_model(qn), sharding.copy_to_model(kn)
        q = rms_norm(q, qn, cfg.norm_eps)
        k = rms_norm(k, kn, cfg.norm_eps)
    rot = int(hd * cfg.rope_fraction) - (int(hd * cfg.rope_fraction) % 2)
    if rot:
        cos, sin = rope_angles(positions, rot, cfg.rope_theta)
        q = apply_rope(q, cos, sin, cfg.rope_fraction)
        k = apply_rope(k, cos, sin, cfg.rope_fraction)
    return q, k, v


def _causal_mask(S: int, window: Optional[int], device) -> torch.Tensor:
    """(S, S) additive fp32 mask: 0 where visible, NEG_INF elsewhere."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    ok = j <= i
    if window is not None:
        ok = ok & ((i - j) < window)
    return torch.where(ok, 0.0, NEG_INF)


def _group(q: torch.Tensor, Hkv: int) -> torch.Tensor:
    """q (B,S,Hq,hd) -> (B,Hkv,G,S,hd)."""
    B, S, Hq, hd = q.shape
    return q.reshape(B, S, Hkv, Hq // Hkv, hd).permute(0, 2, 3, 1, 4)


def _attend(qg, k, v, mask, dtype):
    """qg (B,Hkv,G,Sq,hd), k/v (B,Sk,Hkv,hd), mask broadcast to
    (Sq, Sk) -> (B,Sq,Hq*hd): fp32 scores and softmax, weights cast to
    ``dtype`` before the PV product (the reference's ``_sdpa``)."""
    B, Hkv, G, Sq, hd = qg.shape
    kt = k.permute(0, 2, 3, 1)[:, :, None].float()       # (B,Hkv,1,hd,Sk)
    scores = (qg.float() @ kt) * (hd ** -0.5) + mask
    w = torch.softmax(scores, dim=-1).to(dtype)
    out = w @ v.permute(0, 2, 1, 3)[:, :, None]          # (B,Hkv,G,Sq,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hkv * G * hd)


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q (B,S,Hq,hd), k/v (B,S2,Hkv,hd), mask (S,S2) additive."""
    return _attend(_group(q, k.shape[2]), k, v, mask, q.dtype)


def _kernel_route(q: torch.Tensor) -> bool:
    """Whether ``_chunked_sdpa`` attends through the flash kernels: bf16 on
    the card at a head dim they run (up to 128)."""
    return q.is_cuda and q.dtype == torch.bfloat16 and \
        q.shape[-1] <= HEAD_DIMS[-1]


def _chunked_sdpa(q, k, v, window: Optional[int], cfg: ModelConfig):
    """Query-chunked causal attention: O(S * chunk) score memory instead of
    O(S^2).  Exact (full-row softmax per chunk).  The last chunk is cut at
    S instead of padded (padded rows are sliced away in the reference).

    On the kernel route (``_kernel_route``) one fused flash-attention call
    (forward + backward kernels) replaces the chunk loop: its scores never
    leave the chip, so no chunk needs recomputing."""
    B, S, Hq, hd = q.shape
    if _kernel_route(q):
        out = flash_ops.flash_attention(q, k, v, causal=True, window=window)
        return out.reshape(B, S, Hq * hd)
    C = min(cfg.attn_chunk, S)
    j = torch.arange(S, device=q.device)[None, :]
    qg = _group(q, k.shape[2])
    outs = []
    for i0 in range(0, S, C):
        i = i0 + torch.arange(min(C, S - i0), device=q.device)[:, None]
        ok = j <= i
        if window is not None:
            ok = ok & ((i - j) < window)
        mask = torch.where(ok, 0.0, NEG_INF)
        args = (qg[:, :, :, i0:i0 + C], k, v, mask)
        if cfg.remat:
            # recomputed in the backward pass: one chunk's fp32 scores
            # and their grads live at a time (models/remat.py)
            out, = remat(lambda _, *a: (_attend(*a, q.dtype),), (), *args)
        else:
            out = _attend(*args, q.dtype)
        outs.append(out)
    return torch.cat(outs, dim=1)


def attention_full(cfg: ModelConfig, p: PyTree, x: torch.Tensor,
                   positions: torch.Tensor,
                   window: Optional[int] = "cfg",
                   seq: bool = False) -> torch.Tensor:
    """Full-sequence causal attention (training / scoring compute)."""
    if window == "cfg":
        window = cfg.sliding_window
    split = _split(cfg, p)
    x = sharding.enter(x, split, seq)
    q, k, v = _project_qkv(cfg, p, x, positions)
    if cfg.attn_impl == "flash":
        out = flash_ops.flash_attention(q, k, v, causal=True, window=window)
        out = out.reshape(x.shape[0], x.shape[1], -1)
    elif cfg.attn_impl == "chunked":
        out = _chunked_sdpa(q, k, v, window, cfg)
    else:
        mask = _causal_mask(x.shape[1], window, x.device)
        out = _sdpa(q, k, v, mask, cfg)
    return sharding.leave(out @ p["o"]["w"], split, seq)


def attention_prefill(cfg: ModelConfig, p: PyTree, x: torch.Tensor,
                      positions: torch.Tensor, flash: bool = False,
                      seq: bool = False):
    """Full-sequence attention that also returns its K/V for the cache:
    (y (B,S,D), k, v (B,S,Hkv,hd)), k / v over the whole sequence.
    Attends with the plain ``_sdpa``, as the reference's prefill does, or
    with ``flash``."""
    split = _split(cfg, p)
    x = sharding.enter(x, split, seq)
    q, k, v = _project_qkv(cfg, p, x, positions)
    if flash:
        out = flash_ops.flash_attention(q, k, v, causal=True,
                                        window=cfg.sliding_window)
        out = out.reshape(x.shape[0], x.shape[1], -1)
    else:
        mask = _causal_mask(x.shape[1], cfg.sliding_window, x.device)
        out = _sdpa(q, k, v, mask, cfg)
    return sharding.leave(out @ p["o"]["w"], split, seq), k, v


# ---------------------------------------------------------------------------
# KV cache (ring buffer when window-limited)
# ---------------------------------------------------------------------------

def make_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  n_layers: int, dtype, device=None) -> PyTree:
    """Cache leaves carry a leading layer axis.

    ``max_len`` should be min(context, sliding_window) -- the ring buffer.
    ``kpos`` tracks the absolute position stored in each slot (-1 = empty);
    it is shared across batch (decode is lock-step).  Under a model group
    the cache holds the rank's kv heads (``local_heads``).
    """
    hd = cfg.resolved_head_dim
    shape = (n_layers, batch, max_len, local_heads(cfg)[1], hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "kpos": torch.full((n_layers, max_len), -1, dtype=torch.int32,
                           device=device),
    }


def attention_decode(cfg: ModelConfig, p: PyTree, x: torch.Tensor,
                     cache: PyTree, pos: int,
                     window: Optional[int] = "cfg"
                     ) -> Tuple[torch.Tensor, PyTree]:
    """One decode step.  x (B,1,D); cache leaves per-layer (no layer axis
    here -- the block loop slices it).  pos: the absolute position (an int
    or a 0-d integer tensor).

    Returns (y (B,1,D), the cache, updated in place)."""
    if window == "cfg":
        window = cfg.sliding_window
    pos = int(pos)
    B = x.shape[0]
    split = _split(cfg, p)
    if split:
        x = sharding.copy_to_model(x)
    at = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, at)
    W = cache["k"].shape[1]
    slot = pos % W
    ck, cv, kpos = cache["k"], cache["v"], cache["kpos"]
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]
    kpos[slot] = pos

    age = pos - kpos                                     # (W,)
    ok = (kpos >= 0) & (age >= 0)
    if window is not None:
        ok = ok & (age < window)
    mask = torch.where(ok, 0.0, NEG_INF)                 # (W,)
    qg = q.reshape(B, 1, k.shape[2], -1, q.shape[-1]
                   ).permute(0, 2, 3, 1, 4)              # (B,Hkv,G,1,hd)
    out = _attend(qg, ck, cv, mask, q.dtype)             # (B,1,Hq*hd)
    y = out @ p["o"]["w"]
    return (sharding.reduce_from_model(y) if split else y), cache
