"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434; port of
``repro.models.mla``).

Keys/values are generated from a low-rank latent ``c_kv`` (kv_lora_rank)
plus a small shared rotary key ``k_rope``.  Decode caches only
``(c_kv, k_rope)`` and uses weight absorption: ``q_nope`` is mapped
through ``W_UK`` into latent space, so scores and values are computed
directly against the latent cache, whose slot ``pos % W`` decode writes
in place.

The full-sequence path has no flash branch, as in the reference: with
``attn_impl='flash'`` (or ``'ref'``) it materialises (B, H, S, S) fp32
scores; ``'chunked'`` keeps them at (B, H, C, S).  The reference's
``preferred_element_type=float32`` score products are products of fp32
upcasts here (a bf16 product is exact in fp32), and the scores are summed,
scaled and masked in place, in the reference's order.

Tensor parallelism (``models.sharding``): a rank may hold whole heads --
the columns of ``wq`` / ``wq_b`` and ``wkv_b`` of its heads and the rows
of ``wo`` -- and counts them from its ``wq_b`` / ``wq`` width, checked
against ``wkv_b``'s (``_local_heads``).  The latent projections
(``wq_a``, ``q_norm``, ``wkv_a``, ``kv_norm``) stay replicated and run on
every rank; their outputs (the normed q latent, ``c_kv``, ``k_rope``)
enter the split weights through ``copy_to_model``, where each rank's
heads read them (on the block input instead, the replicated weights'
gradients would hold only the rank's heads).  The latent cache has no
head axis and is whole on every rank; absorbed decode reads the rank's
``w_uk`` / ``w_uv`` columns, and ``wo``'s partial sums leave through
``reduce_from_model`` (``scatter_seq`` under sequence parallelism).
Where the heads do not split (``sharding.whole_heads``) MLA runs whole
on every rank.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from . import sharding
from .attention import NEG_INF
from .config import ModelConfig
from .layers import lecun_normal, rms_norm, rope_angles

PyTree = Any

__all__ = ["mla_init", "mla_full", "mla_decode", "make_mla_cache"]


def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> PyTree:
    d, H = cfg.d_model, cfg.n_heads
    r, rq = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    p = {
        "wkv_a": lecun_normal(gen, (d, r + dr), dtype),
        "kv_norm": torch.ones((r,), dtype=dtype, device=gen.device),
        "wkv_b": lecun_normal(gen, (r, H * (dn + dv)), dtype),
        "wo": lecun_normal(gen, (H * dv, d), dtype),
    }
    if rq:
        p["wq_a"] = lecun_normal(gen, (d, rq), dtype)
        p["q_norm"] = torch.ones((rq,), dtype=dtype, device=gen.device)
        p["wq_b"] = lecun_normal(gen, (rq, H * (dn + dr)), dtype)
    else:
        p["wq"] = lecun_normal(gen, (d, H * (dn + dr)), dtype)
    return p


def _rotate(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate-half RoPE of ``t``'s last axis; cos/sin cast to t's dtype."""
    half = t.shape[-1] // 2
    c, s = cos.to(t.dtype), sin.to(t.dtype)
    t1, t2 = t[..., :half], t[..., half:]
    return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s], dim=-1)


def _local_heads(cfg: ModelConfig, p: PyTree) -> Tuple[int, bool]:
    """(heads this rank holds, whether that is a shard): from the q
    projection's width, checked against ``wkv_b``'s."""
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    wq = p["wq_b"] if cfg.q_lora_rank else p["wq"]
    H = wq.shape[-1] // (dn + dr)
    if p["wkv_b"].shape[-1] != H * (dn + dv):
        raise ValueError(f"MLA weights of {H} q heads but a wkv_b of "
                         f"{p['wkv_b'].shape[-1]} columns")
    return H, sharding.holds_shard(H, cfg.n_heads)


def _queries(cfg: ModelConfig, p: PyTree, xs, xr, positions, split: bool):
    """-> q_nope (B,S,H,dn), q_rope (B,S,H,dr) (roped), on the rank's
    heads: ``xs`` the input of its split weights, ``xr`` of the
    replicated q latent."""
    B, S, _ = xs.shape
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank:
        q_lat = rms_norm(xr @ p["wq_a"], p["q_norm"], cfg.norm_eps)
        if split:
            q_lat = sharding.copy_to_model(q_lat)
        q = q_lat @ p["wq_b"]
    else:
        q = xs @ p["wq"]
    q = q.reshape(B, S, -1, dn + dr)
    cos, sin = rope_angles(positions, dr, cfg.rope_theta)
    return q[..., :dn], _rotate(q[..., dn:], cos[:, None], sin[:, None])


def _latents(cfg: ModelConfig, p: PyTree, x, positions):
    """-> c_kv (B,S,r) [normed], k_rope (B,S,dr) (roped, head-shared)."""
    r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
    kv = x @ p["wkv_a"]
    c_kv = rms_norm(kv[..., :r], p["kv_norm"], cfg.norm_eps)
    cos, sin = rope_angles(positions, dr, cfg.rope_theta)
    return c_kv, _rotate(kv[..., r:], cos, sin)


def _inputs(cfg: ModelConfig, p: PyTree, x, positions, seq: bool):
    """The layer's input as its split and replicated weights take it
    (``sharding.layer_inputs``), the roped queries on the rank's heads,
    and the latents -- as the cache keeps them and as the split weights
    read them (through ``copy_to_model`` when the heads split)."""
    H, split = _local_heads(cfg, p)
    if split:
        xs, xr = sharding.layer_inputs(x, seq)
    else:
        xs = xr = sharding.enter(x, False, seq)
    q_nope, q_rope = _queries(cfg, p, xs, xr, positions, split)
    c_kv, k_rope = _latents(cfg, p, xr, positions)
    if split:
        c_in, k_in = sharding.copy_to_model(c_kv), \
            sharding.copy_to_model(k_rope)
    else:
        c_in, k_in = c_kv, k_rope
    return H, split, q_nope, q_rope, (c_kv, k_rope), (c_in, k_in)


def _scores(q_a, k_a, eq_a, q_b, k_b, eq_b, scale, mask):
    """(einsum(eq_a) + einsum(eq_b)) * scale + mask in fp32, each term a
    product of fp32 upcasts, summed in place."""
    s = torch.einsum(eq_a, q_a.float(), k_a.float())
    s += torch.einsum(eq_b, q_b.float(), k_b.float())
    s *= scale
    s += mask
    return s


def _visible_mask(i: torch.Tensor, S: int, window) -> torch.Tensor:
    j = torch.arange(S, device=i.device)[None, :]
    ok = j <= i
    if window is not None:
        ok = ok & ((i - j) < window)
    return torch.where(ok, 0.0, NEG_INF)


def mla_full(cfg: ModelConfig, p: PyTree, x: torch.Tensor,
             positions: torch.Tensor,
             window: Optional[int] = "cfg", seq: bool = False,
             latents: bool = False):
    """Full-sequence causal MLA (scoring / prefill): materialises per-head
    K/V from the latent.  ``seq``: ``x`` is the rank's rows of the
    sequence (sequence parallelism) and so is the output.  ``latents``:
    also return (c_kv, k_rope) over the whole sequence, the prefill
    cache's entries."""
    if window == "cfg":
        window = cfg.sliding_window
    B = x.shape[0]
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    H, split, q_nope, q_rope, lat, (c_kv, k_rope) = _inputs(
        cfg, p, x, positions, seq)
    S = q_nope.shape[1]
    kv = (c_kv @ p["wkv_b"]).reshape(B, S, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    scale = (dn + dr) ** -0.5
    C = min(cfg.attn_chunk, S) if cfg.attn_impl == "chunked" else S
    outs = []
    # query chunks of C rows (one chunk unless 'chunked'); the last chunk
    # is cut at S, where the reference pads it and slices the rows away
    for i0 in range(0, S, C):
        i = i0 + torch.arange(min(C, S - i0), device=x.device)[:, None]
        s = _scores(q_nope[:, i0:i0 + C], k_nope, "bshd,bthd->bhst",
                    q_rope[:, i0:i0 + C], k_rope, "bshd,btd->bhst", scale,
                    _visible_mask(i, S, window))
        s = torch.softmax(s, dim=-1)           # frees the scores
        w = s.to(x.dtype)
        del s
        outs.append(torch.einsum("bhst,bthd->bshd", w, v))
        del w
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    y = sharding.leave(out.reshape(B, S, H * dv) @ p["wo"], split, seq)
    return (y, lat) if latents else y


def make_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   n_layers: int, dtype, device=None) -> PyTree:
    return {
        "ckv": torch.zeros((n_layers, batch, max_len, cfg.kv_lora_rank),
                           dtype=dtype, device=device),
        "krope": torch.zeros((n_layers, batch, max_len, cfg.rope_head_dim),
                             dtype=dtype, device=device),
        "kpos": torch.full((n_layers, max_len), -1, dtype=torch.int32,
                           device=device),
    }


def mla_decode(cfg: ModelConfig, p: PyTree, x: torch.Tensor, cache: PyTree,
               pos, window: Optional[int] = "cfg"
               ) -> Tuple[torch.Tensor, PyTree]:
    """One decode step with the absorbed latent cache.

    x (B,1,D); cache leaves per layer: ckv (B,W,r), krope (B,W,dr),
    kpos (W,), written in place at slot ``pos % W``.  pos: the absolute
    position (an int or a 0-d integer tensor)."""
    if window == "cfg":
        window = cfg.sliding_window
    pos = int(pos)
    B = x.shape[0]
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    at = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    H, split, q_nope, q_rope, (c_kv, k_rope), _ = _inputs(cfg, p, x, at,
                                                          False)

    ckv, krope, kpos = cache["ckv"], cache["krope"], cache["kpos"]
    slot = pos % ckv.shape[1]
    ckv[:, slot] = c_kv[:, 0]
    krope[:, slot] = k_rope[:, 0]
    kpos[slot] = pos
    if split:       # the split weights read the (whole) cache's latents
        ckv, krope = sharding.copy_to_model(ckv), \
            sharding.copy_to_model(krope)

    # weight absorption: W_UK (r, H, dn) pulled out of wkv_b (the rank's
    # heads' columns)
    wkv_b = p["wkv_b"].reshape(r, H, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)    # (B,1,H,r)

    age = pos - kpos
    ok = (kpos >= 0) & (age >= 0)
    if window is not None:
        ok = ok & (age < window)
    s = _scores(q_lat, ckv, "bshr,btr->bhst", q_rope, krope,
                "bshd,btd->bhst", (dn + dr) ** -0.5,
                torch.where(ok, 0.0, NEG_INF))
    wts = torch.softmax(s, dim=-1).to(x.dtype)
    out_lat = torch.einsum("bhst,btr->bshr", wts, ckv)      # (B,1,H,r)
    out = torch.einsum("bshr,rhd->bshd", out_lat, w_uv)     # (B,1,H,dv)
    return sharding.leave(out.reshape(B, 1, H * dv) @ p["wo"], split,
                          False), cache
