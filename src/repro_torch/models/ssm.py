"""Mamba2 / SSD blocks (arXiv:2405.21060, state-space duality; port of
``repro.models.ssm``).

Prefill and scoring use the chunked SSD algorithm: within a chunk the
output is computed in "attention form" (quadratic in the chunk length);
across chunks a recurrence carries the (H, N, P) fp32 state, a Python
loop over chunks where the reference has a ``lax.scan``.  Decode is the
O(1) recurrent step on the cached (conv window, ssm state), written into
the cache in place.

Projections are separate matrices (w_x, w_z, w_B, w_C, w_dt), the
reference's tree.  ``dt_bias``, ``A_log`` and ``D`` are fp32 in every
model dtype.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import lecun_normal, rms_norm

PyTree = Any

__all__ = ["ssm_init", "ssm_forward", "ssm_prefill", "ssm_decode",
           "make_ssm_cache"]


def ssm_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> PyTree:
    d, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    W = cfg.ssm_conv_width
    dev = gen.device
    conv_ch = di + 2 * G * N
    # dt bias so that softplus(dt_bias) spans [1e-3, 1e-1] (mamba2 default)
    u = torch.rand((H,), generator=gen, device=dev) * (1e-1 - 1e-3) + 1e-3
    return {
        "w_x": lecun_normal(gen, (d, di), dtype),
        "w_z": lecun_normal(gen, (d, di), dtype),
        "w_B": lecun_normal(gen, (d, G * N), dtype),
        "w_C": lecun_normal(gen, (d, G * N), dtype),
        "w_dt": lecun_normal(gen, (d, H), dtype),
        "dt_bias": u + torch.log(-torch.expm1(-u)),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
        "D": torch.ones((H,), device=dev),
        "conv_w": (torch.randn((W, conv_ch), generator=gen, device=dev)
                   / W).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "gate_norm": torch.ones((di,), dtype=dtype, device=dev),
        "w_out": lecun_normal(gen, (di, d), dtype),
    }


def _proj_conv(cfg: ModelConfig, p: PyTree, x: torch.Tensor):
    """x (B,L,d) -> (xin (B,L,di), z, Bmat (B,L,G,N), Cmat, dt (B,L,H)
    fp32, xBC_raw) after the depthwise causal conv on [x, B, C] (z and dt
    are not convolved).  ``xBC_raw`` is the pre-conv channel stack: its
    last W-1 rows seed the decode conv cache."""
    B, L, _ = x.shape
    G, N = cfg.ssm_groups, cfg.ssm_state
    di, W = cfg.d_inner, cfg.ssm_conv_width
    z = x @ p["w_z"]
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])
    xBC = torch.cat([x @ p["w_x"], x @ p["w_B"], x @ p["w_C"]], dim=-1)
    # depthwise causal conv of width W, its terms added in tap order
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    conv = pad[:, 0:L] * p["conv_w"][0]
    for i in range(1, W):
        conv = conv + pad[:, i:i + L] * p["conv_w"][i]
    conv = F.silu(conv + p["conv_b"])
    xin = conv[..., :di]
    Bmat = conv[..., di:di + G * N].reshape(B, L, G, N)
    Cmat = conv[..., di + G * N:].reshape(B, L, G, N)
    return xin, z, Bmat, Cmat, dt, xBC


def _expand_groups(mat: torch.Tensor, H: int) -> torch.Tensor:
    """(B,...,G,N) -> (B,...,H,N), each group repeated over its heads
    (``jnp.repeat``; an expand, where ``repeat_interleave`` would sync the
    host with the card)."""
    *lead, G, N = mat.shape
    if H == G:
        return mat
    return mat[..., None, :].expand(*lead, G, H // G, N).reshape(*lead, H, N)


def ssm_forward(cfg: ModelConfig, p: PyTree, x: torch.Tensor
                ) -> torch.Tensor:
    """Chunked SSD scan. x (B,L,d) -> (B,L,d); a ragged L is padded to a
    multiple of ``ssm_chunk`` inside."""
    return _ssd_with_state(cfg, p, x)[0]


def ssm_prefill(cfg: ModelConfig, p: PyTree, x: torch.Tensor):
    """Forward + the decode cache seeds: (y, final_state (B,H,N,P) fp32,
    conv_tail (B,W-1,ch))."""
    return _ssd_with_state(cfg, p, x)


def _ssd_with_state(cfg: ModelConfig, p: PyTree, x: torch.Tensor):
    B, L_in, _ = x.shape
    Q = cfg.ssm_chunk
    pad = (-L_in) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    L = L_in + pad
    nc = L // Q
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim

    xin, z, Bm, Cm, dt, xBC_raw = _proj_conv(cfg, p, x)
    if pad:
        # padded steps are the identity for the recurrence: dt = 0 gives
        # decay exp(0) = 1 and no input
        valid = (torch.arange(L, device=x.device) < L_in)[None, :, None]
        dt = torch.where(valid, dt, 0.0)
    xh = xin.reshape(B, nc, Q, H, P).float()
    Bh = _expand_groups(Bm, H).reshape(B, nc, Q, H, N).float()
    Ch = _expand_groups(Cm, H).reshape(B, nc, Q, H, N).float()
    dt = dt.reshape(B, nc, Q, H)

    A = -torch.exp(p["A_log"])                                # (H,) < 0
    cum = torch.cumsum(dt * A, dim=2)                         # within chunk
    cum_end = cum[:, :, -1]                                   # (B,nc,H)

    # intra-chunk (attention form)
    scores = torch.einsum("bcqhn,bcshn->bchqs", Ch, Bh)       # (B,nc,H,Q,Q)
    cum_h = cum.permute(0, 1, 3, 2)                           # (B,nc,H,Q)
    # exp(cum[q] - cum[s]) overflows to inf above the diagonal: those
    # entries are dropped by the where (a multiply by a mask gives NaN)
    decay = torch.exp(cum_h[..., :, None] - cum_h[..., None, :])
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    M = torch.where(causal, scores * decay, 0.0)
    del scores, decay
    Mdt = M * dt.permute(0, 1, 3, 2)[:, :, :, None, :]        # weight dt[s]
    y_intra = torch.einsum("bchqs,bcshp->bcqhp", Mdt, xh)
    del M, Mdt

    # chunk states
    decay_out = torch.exp(cum_end[:, :, None] - cum)          # (B,nc,Q,H)
    S = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", decay_out * dt, Bh, xh)

    # inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(cum_end)                          # (B,nc,H)
    state = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    before = []
    for c in range(nc):
        before.append(state)
        state = chunk_decay[:, c, :, None, None] * state + S[:, c]
    states_before = torch.stack(before, dim=1)                # (B,nc,H,N,P)

    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", Ch, states_before)
    y_inter = y_inter * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(B, L, H, P)
    y = y + p["D"][:, None] * xin.reshape(B, L, H, P).float()
    y = y.reshape(B, L, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = (y @ p["w_out"])[:, :L_in]

    W = cfg.ssm_conv_width
    tail = F.pad(xBC_raw[:, :L_in], (0, 0, W - 1, 0))[:, L_in:]
    return out, state, tail


# ---------------------------------------------------------------------------
# Decode (O(1) recurrent step)
# ---------------------------------------------------------------------------

def make_ssm_cache(cfg: ModelConfig, batch: int, n_layers: int, dtype,
                   device=None) -> PyTree:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv_width - 1,
                             conv_ch), dtype=dtype, device=device),
        "state": torch.zeros((n_layers, batch, cfg.ssm_heads, cfg.ssm_state,
                              cfg.ssm_head_dim), dtype=torch.float32,
                             device=device),
    }


def ssm_decode(cfg: ModelConfig, p: PyTree, x: torch.Tensor, cache: PyTree
               ) -> Tuple[torch.Tensor, PyTree]:
    """One token step. x (B,1,d); cache per layer: conv (B,W-1,ch),
    state (B,H,N,P) fp32, both updated in place."""
    B = x.shape[0]
    G, N = cfg.ssm_groups, cfg.ssm_state
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    xt = x[:, 0]                                              # (B,d)

    z = xt @ p["w_z"]
    dt = F.softplus((xt @ p["w_dt"]).float() + p["dt_bias"])
    xBC = torch.cat([xt @ p["w_x"], xt @ p["w_B"], xt @ p["w_C"]], dim=-1)

    # a fresh (B,W,ch) window; the cache takes its last W-1 rows (copying
    # the cache onto itself shifted by a row would overlap)
    win = torch.cat([cache["conv"], xBC[:, None]], dim=1)
    conv = F.silu(torch.einsum("bwc,wc->bc", win, p["conv_w"])
                  + p["conv_b"])
    cache["conv"].copy_(win[:, 1:])

    xin = conv[:, :di].reshape(B, H, P).float()
    Bm = _expand_groups(conv[:, di:di + G * N].reshape(B, G, N), H).float()
    Cm = _expand_groups(conv[:, di + G * N:].reshape(B, G, N), H).float()

    dA = torch.exp(dt * -torch.exp(p["A_log"]))               # (B,H)
    state = (dA[..., None, None] * cache["state"]
             + torch.einsum("bh,bhn,bhp->bhnp", dt, Bm, xin))
    cache["state"].copy_(state)
    y = torch.einsum("bhn,bhnp->bhp", Cm, state)
    y = y + p["D"][:, None] * xin
    y = y.reshape(B, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return (y @ p["w_out"])[:, None], cache
