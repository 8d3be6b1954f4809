"""Plain PyTorch versions of flash attention (port of
``repro.kernels.flash_attention.ref``).

* ``attention_ref``       -- the reference's oracle on the model's
                             (B, S, H, hd) layout: causal (optionally
                             sliding-window) GQA attention, scores and
                             softmax in fp32, the weights cast to
                             ``q.dtype`` before the PV product, ends
                             aligned for ``Sq != Sk``.
* ``flash_attention_ref`` -- the CUDA kernel's plain version, on the
                             kernel's (B, H, S, hd) layout: what
                             ``_flash_kernel`` computes.  q, k and v are
                             upcast to fp32, the scores are
                             ``(q . k) * hd**-0.5`` (scale after the
                             dot), masked entries get weight 0 (not
                             ``exp(0)``), ``p`` stays fp32 through the PV
                             product, the row sum of a row with no
                             visible key is taken as 1 (the row comes out
                             0), and the output is cast to ``q.dtype``.
                             Rows and columns are absolute positions
                             (no end alignment), columns at or past
                             ``true_seq_k`` are masked.  With
                             ``with_lse`` it also returns each row's
                             log-sum-exp of its visible scaled scores
                             (fp32, ``-inf`` for a row with no visible
                             key): what the kernel saves for its
                             backward.
* ``flash_attention_bwd_ref`` -- the backward kernels' plain version:
                             dq, dk, dv from q, k, v, the output, its
                             LSE and the output's gradient, as the
                             kernels compute them (the weights rebuilt as
                             ``exp(s - lse)``, ``D = rowsum(do * o)`` in
                             fp32, ``ds = p * (do v^T - D)``, every
                             product in fp32).

At bf16 the two forwards differ only by the rounding of the weights.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_ref", "flash_attention_ref", "flash_attention_bwd_ref",
           "NEG_INF"]

NEG_INF = -1e30


def _visible(Sq: int, Sk: int, causal: bool, window: Optional[int],
             offset: int, seq_k: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: key ``j`` visible from query ``i`` (query position
    ``i + offset``)."""
    i = torch.arange(Sq, device=device)[:, None] + offset
    j = torch.arange(Sk, device=device)[None, :]
    ok = j < seq_k
    if causal:
        ok = ok & (j <= i)
    if window is not None:
        ok = ok & ((i - j) < window)
    return ok


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q (B,Sq,Hq,hd), k/v (B,Sk,Hkv,hd) -> (B,Sq,Hq,hd).

    Hq must be a multiple of Hkv (grouped queries).  Scores/softmax in f32.
    """
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd).permute(0, 2, 3, 1, 4).float()
    kt = k.permute(0, 2, 3, 1).float()[:, :, None]       # (B,Hkv,1,hd,Sk)
    scores = (qg @ kt) * (hd ** -0.5)                     # (B,Hkv,G,Sq,Sk)
    ok = _visible(Sq, Sk, causal, window, Sk - Sq, Sk, q.device)
    scores = scores + torch.where(ok, 0.0, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = w @ v.permute(0, 2, 1, 3)[:, :, None]          # (B,Hkv,G,Sq,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        true_seq_k: Optional[int] = None,
                        with_lse: bool = False):
    """q (B,Hq,Sq,hd), k/v (B,Hkv,Sk,hd) -> (B,Hq,Sq,hd) in q's dtype, and
    with ``with_lse`` the rows' log-sum-exp (B,Hq,Sq) fp32 beside it."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    seq_k = Sk if true_seq_k is None else true_seq_k
    qg = q.reshape(B, Hkv, G, Sq, hd).float()
    kt = k.float().transpose(-1, -2)[:, :, None]          # (B,Hkv,1,hd,Sk)
    s = (qg @ kt) * (hd ** -0.5)                          # (B,Hkv,G,Sq,Sk)
    ok = _visible(Sq, Sk, causal, window, 0, seq_k, q.device)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    dead = l == 0.0
    l = torch.where(dead, 1.0, l)                         # dead rows -> 0
    out = (p @ v.float()[:, :, None]) / l                 # (B,Hkv,G,Sq,hd)
    out = out.reshape(B, Hq, Sq, hd).to(q.dtype)
    if not with_lse:
        return out
    lse = torch.where(dead, -torch.inf, m + torch.log(l))
    return out, lse.reshape(B, Hq, Sq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            true_seq_k: Optional[int] = None):
    """q, o, do (B,Hq,Sq,hd), k/v (B,Hkv,Sk,hd), lse (B,Hq,Sq) fp32 ->
    (dq, dk, dv) in q's dtype, dk / dv summed over each kv head's group
    of q heads."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    seq_k = Sk if true_seq_k is None else true_seq_k
    scale = hd ** -0.5
    qg = q.reshape(B, Hkv, G, Sq, hd).float()
    kf = k.float()[:, :, None]                            # (B,Hkv,1,Sk,hd)
    vf = v.float()[:, :, None]
    dog = do.reshape(B, Hkv, G, Sq, hd).float()
    s = (qg @ kf.transpose(-1, -2)) * scale               # (B,Hkv,G,Sq,Sk)
    ok = _visible(Sq, Sk, causal, window, 0, seq_k, q.device)
    p = torch.where(ok, torch.exp(s - lse.reshape(B, Hkv, G, Sq, 1)), 0.0)
    d = (dog * o.reshape(B, Hkv, G, Sq, hd).float()).sum(-1, keepdim=True)
    ds = p * (dog @ vf.transpose(-1, -2) - d)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qg).sum(2) * scale
    dv = (p.transpose(-1, -2) @ dog).sum(2)
    return (dq.reshape(B, Hq, Sq, hd).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))
