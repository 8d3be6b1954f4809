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

Tensor parallelism (``models.sharding``): a rank may hold whole heads --
the columns of ``w_x``, ``w_z``, ``w_dt``, its slices of ``dt_bias``,
``A_log``, ``D`` and ``gate_norm``, and its rows of ``w_out`` -- and
counts them from its ``w_x`` width.  ``w_B`` / ``w_C`` split into whole
groups where the groups divide (``sharding.whole_groups``), else they
stay whole: every rank then projects and convolves the whole ``B`` /
``C`` and feeds them to its heads through ``copy_to_model``.  The conv
runs on the rank's channels ``[x_local | B | C]``, sliced out of the
replicated ``conv_w`` / ``conv_b`` (the split channels' slices through
``copy_to_model``: a rank's gradient covers its own channels only), the
gate norm over the whole ``d_inner`` is ``layers.rms_norm_split``, and
``w_out``'s partial sums leave through ``reduce_from_model``
(``scatter_seq`` under sequence parallelism).  The decode cache holds
the rank's conv channels and state heads.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from . import sharding
from .config import ModelConfig
from .layers import lecun_normal, rms_norm, rms_norm_split

PyTree = Any

__all__ = ["ssm_init", "ssm_forward", "ssm_prefill", "ssm_decode",
           "make_ssm_cache", "local_sizes"]


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


class _Local:
    """What a rank holds of one SSD layer, read from its weights: ``H``
    heads (all of them unless ``split``), their first global index
    ``h0``, ``G`` groups of ``w_B`` / ``w_C`` (``groups_split``: the
    rank's own), and the rank's conv channels."""

    def __init__(self, cfg: ModelConfig, p: PyTree):
        di, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
        self.di = p["w_x"].shape[-1]
        self.split = sharding.holds_shard(self.di, di)
        self.H = self.di // P
        self.G = p["w_B"].shape[-1] // N
        self.groups_split = self.split and self.G != cfg.ssm_groups
        r = sharding.model_rank()[0] if self.split else 0
        self.h0 = r * self.H
        GN = cfg.ssm_groups * N
        g0 = r * self.G * N if self.groups_split else 0
        self.x_cols = slice(r * self.di, (r + 1) * self.di)
        self.b_cols = slice(di + g0, di + g0 + self.G * N)
        self.c_cols = slice(di + GN + g0, di + GN + g0 + self.G * N)


def _conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor, L: int,
          W: int) -> torch.Tensor:
    """The depthwise causal conv of width W over (B, L, ch), its terms
    added in tap order, then SiLU."""
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    conv = pad[:, 0:L] * w[0]
    for i in range(1, W):
        conv = conv + pad[:, i:i + L] * w[i]
    return F.silu(conv + b)


def _proj_conv(cfg: ModelConfig, p: PyTree, xs: torch.Tensor,
               xr: torch.Tensor, loc: _Local):
    """x (B,L,d) -> (xin (B,L,di), z, Bmat (B,L,G,N), Cmat, dt (B,L,H)
    fp32, xBC_raw) after the depthwise causal conv on [x, B, C] (z and dt
    are not convolved), on the rank's heads, groups and channels: ``xs``
    the input of its split weights, ``xr`` of the whole ``w_B`` / ``w_C``.
    ``xBC_raw`` is the pre-conv channel stack: its last W-1 rows seed the
    decode conv cache."""
    B, L, _ = xs.shape
    N, W = cfg.ssm_state, cfg.ssm_conv_width
    di, G = loc.di, loc.G
    z = xs @ p["w_z"]
    dt = F.softplus((xs @ p["w_dt"]).float() + p["dt_bias"])
    if not loc.split:
        xBC = torch.cat([xs @ p["w_x"], xs @ p["w_B"], xs @ p["w_C"]],
                        dim=-1)
        conv = _conv(xBC, p["conv_w"], p["conv_b"], L, W)
        Bmat = conv[..., di:di + G * N].reshape(B, L, G, N)
        Cmat = conv[..., di + G * N:].reshape(B, L, G, N)
        return conv[..., :di], z, Bmat, Cmat, dt, xBC
    # the split channels read the replicated conv weights through
    # copy_to_model: this rank's gradient covers its own columns
    cw, cb = sharding.copy_to_model(p["conv_w"]), \
        sharding.copy_to_model(p["conv_b"])
    x_pre = xs @ p["w_x"]
    if loc.groups_split:
        bc_pre = torch.cat([xs @ p["w_B"], xs @ p["w_C"]], dim=-1)
        cols = (loc.b_cols, loc.c_cols)
        w_bc = torch.cat([cw[:, c] for c in cols], dim=-1)
        b_bc = torch.cat([cb[c] for c in cols], dim=-1)
    else:
        bc_pre = torch.cat([xr @ p["w_B"], xr @ p["w_C"]], dim=-1)
        w_bc = p["conv_w"][:, cfg.d_inner:]
        b_bc = p["conv_b"][cfg.d_inner:]
    xin = _conv(x_pre, cw[:, loc.x_cols], cb[loc.x_cols], L, W)
    bc = _conv(bc_pre, w_bc, b_bc, L, W)
    if not loc.groups_split:        # whole B / C into the rank's heads
        bc = sharding.copy_to_model(bc)
    Bmat = bc[..., :G * N].reshape(B, L, G, N)
    Cmat = bc[..., G * N:].reshape(B, L, G, N)
    return xin, z, Bmat, Cmat, dt, torch.cat([x_pre, bc_pre], dim=-1)


def _rank_heads(mat: torch.Tensor, cfg: ModelConfig, loc: _Local
                ) -> torch.Tensor:
    """(B,...,G,N) -> (B,...,H,N) on the rank's heads: each group repeated
    over its heads (``_expand_groups``), or, where the rank reads whole
    groups that are not its own and more than one, the group of each of
    its heads picked out."""
    if loc.groups_split or mat.shape[-2] == 1 or not loc.split:
        return _expand_groups(mat, loc.H)
    rep = cfg.ssm_heads // cfg.ssm_groups
    idx = (loc.h0 + torch.arange(loc.H, device=mat.device)) // rep
    return mat.index_select(-2, idx)


def _expand_groups(mat: torch.Tensor, H: int) -> torch.Tensor:
    """(B,...,G,N) -> (B,...,H,N), each group repeated over its heads
    (``jnp.repeat``; an expand, where ``repeat_interleave`` would sync the
    host with the card)."""
    *lead, G, N = mat.shape
    if H == G:
        return mat
    return mat[..., None, :].expand(*lead, G, H // G, N).reshape(*lead, H, N)


def ssm_forward(cfg: ModelConfig, p: PyTree, x: torch.Tensor,
                seq: bool = False) -> torch.Tensor:
    """Chunked SSD scan. x (B,L,d) -> (B,L,d); a ragged L is padded to a
    multiple of ``ssm_chunk`` inside.  ``seq``: ``x`` is the rank's rows
    of the sequence (sequence parallelism) and so is the output."""
    return _ssd_with_state(cfg, p, x, seq)[0]


def ssm_prefill(cfg: ModelConfig, p: PyTree, x: torch.Tensor,
                seq: bool = False):
    """Forward + the decode cache seeds: (y, final_state (B,H,N,P) fp32,
    conv_tail (B,W-1,ch)), the seeds over the whole sequence."""
    return _ssd_with_state(cfg, p, x, seq)


def _gate_norm(cfg: ModelConfig, p: PyTree, y: torch.Tensor, z, loc):
    """RMSNorm of ``y * silu(z)`` over the whole ``d_inner``."""
    if loc.split:
        return rms_norm_split(y * F.silu(z), p["gate_norm"], cfg.d_inner,
                              cfg.norm_eps)
    return rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)


def _ssd_with_state(cfg: ModelConfig, p: PyTree, x: torch.Tensor,
                    seq: bool = False):
    loc = _Local(cfg, p)
    if loc.split:
        xs, xr = sharding.layer_inputs(x, seq)
    else:
        xs = xr = sharding.enter(x, False, seq)
    B, L_in, _ = xs.shape
    Q = cfg.ssm_chunk
    pad = (-L_in) % Q
    if pad:
        xs = F.pad(xs, (0, 0, 0, pad))
        xr = xs if not loc.split else F.pad(xr, (0, 0, 0, pad))
    L = L_in + pad
    nc = L // Q
    H, N, P = loc.H, cfg.ssm_state, cfg.ssm_head_dim

    xin, z, Bm, Cm, dt, xBC_raw = _proj_conv(cfg, p, xs, xr, loc)
    if pad:
        # padded steps are the identity for the recurrence: dt = 0 gives
        # decay exp(0) = 1 and no input
        valid = (torch.arange(L, device=x.device) < L_in)[None, :, None]
        dt = torch.where(valid, dt, 0.0)
    xh = xin.reshape(B, nc, Q, H, P).float()
    Bh = _rank_heads(Bm, cfg, loc).reshape(B, nc, Q, H, N).float()
    Ch = _rank_heads(Cm, cfg, loc).reshape(B, nc, Q, H, N).float()
    dt = dt.reshape(B, nc, Q, H)

    A = -torch.exp(p["A_log"])                                # (H,) < 0
    cum = torch.cumsum(dt * A, dim=2)                         # within chunk
    cum_end = cum[:, :, -1]                                   # (B,nc,H)

    # intra-chunk (attention form)
    scores = torch.einsum("bcqhn,bcshn->bchqs", Ch, Bh)       # (B,nc,H,Q,Q)
    cum_h = cum.permute(0, 1, 3, 2)                           # (B,nc,H,Q)
    # exp(cum[q] - cum[s]) overflows to inf above the diagonal (at the
    # published chunk of 128, dt |A| sums past 88.7 there).  The reference
    # takes the exp and drops those entries by a where after it, which
    # keeps the forward finite but gives a NaN gradient (the where's zero
    # gradient times inf).  The exponent is masked to -inf before the exp
    # here: the same values on and below the diagonal, exact zeros above,
    # and a finite gradient; equal to the reference's wherever its
    # gradient is finite.
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(
        causal, cum_h[..., :, None] - cum_h[..., None, :], float("-inf")))
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
    y = y.reshape(B, L, H * P).to(x.dtype)
    y = _gate_norm(cfg, p, y, z, loc)
    out = sharding.leave((y @ p["w_out"])[:, :L_in], loc.split, seq)

    W = cfg.ssm_conv_width
    tail = F.pad(xBC_raw[:, :L_in], (0, 0, W - 1, 0))[:, L_in:]
    return out, state, tail


# ---------------------------------------------------------------------------
# Decode (O(1) recurrent step)
# ---------------------------------------------------------------------------

def local_sizes(cfg: ModelConfig) -> Tuple[int, int]:
    """(state heads, conv channels) a rank of the current model group
    holds: all of them unless the heads split (``sharding.ssd_splits``);
    the groups' channels whole unless ``sharding.whole_groups``."""
    GN = cfg.ssm_groups * cfg.ssm_state
    _, m = sharding.model_rank()
    if m == 1 or not sharding.ssd_splits(cfg, m):
        return cfg.ssm_heads, cfg.d_inner + 2 * GN
    bc = 2 * GN // m if sharding.whole_groups(cfg, m) else 2 * GN
    return cfg.ssm_heads // m, cfg.d_inner // m + bc


def make_ssm_cache(cfg: ModelConfig, batch: int, n_layers: int, dtype,
                   device=None) -> PyTree:
    """Under a model group the rank's heads and channels
    (``local_sizes``)."""
    H, conv_ch = local_sizes(cfg)
    return {
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv_width - 1,
                             conv_ch), dtype=dtype, device=device),
        "state": torch.zeros((n_layers, batch, H, cfg.ssm_state,
                              cfg.ssm_head_dim), dtype=torch.float32,
                             device=device),
    }


def ssm_decode(cfg: ModelConfig, p: PyTree, x: torch.Tensor, cache: PyTree
               ) -> Tuple[torch.Tensor, PyTree]:
    """One token step. x (B,1,d); cache per layer: conv (B,W-1,ch),
    state (B,H,N,P) fp32, both updated in place (the rank's channels and
    heads)."""
    B = x.shape[0]
    loc = _Local(cfg, p)
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    di, H, G = loc.di, loc.H, loc.G
    if loc.split:
        xs, xr = sharding.layer_inputs(x, False)
    else:
        xs = xr = x
    xs, xr = xs[:, 0], xr[:, 0]                               # (B,d)

    z = xs @ p["w_z"]
    dt = F.softplus((xs @ p["w_dt"]).float() + p["dt_bias"])
    proj_bc = xs if loc.groups_split or not loc.split else xr
    xBC = torch.cat([xs @ p["w_x"], proj_bc @ p["w_B"],
                     proj_bc @ p["w_C"]], dim=-1)
    if loc.split:
        cols = (loc.x_cols, loc.b_cols, loc.c_cols)
        conv_w = torch.cat([p["conv_w"][:, c] for c in cols], dim=-1)
        conv_b = torch.cat([p["conv_b"][c] for c in cols], dim=-1)
    else:
        conv_w, conv_b = p["conv_w"], p["conv_b"]

    # a fresh (B,W,ch) window; the cache takes its last W-1 rows (copying
    # the cache onto itself shifted by a row would overlap)
    win = torch.cat([cache["conv"], xBC[:, None]], dim=1)
    conv = F.silu(torch.einsum("bwc,wc->bc", win, conv_w) + conv_b)
    cache["conv"].copy_(win[:, 1:])

    xin = conv[:, :di].reshape(B, H, P).float()
    Bm = _rank_heads(conv[:, di:di + G * N].reshape(B, G, N), cfg,
                     loc).float()
    Cm = _rank_heads(conv[:, di + G * N:].reshape(B, G, N), cfg,
                     loc).float()

    dA = torch.exp(dt * -torch.exp(p["A_log"]))               # (B,H)
    state = (dA[..., None, None] * cache["state"]
             + torch.einsum("bh,bhn,bhp->bhnp", dt, Bm, xin))
    cache["state"].copy_(state)
    y = torch.einsum("bhn,bhnp->bhp", Cm, state)
    y = y + p["D"][:, None] * xin
    y = y.reshape(B, di).to(x.dtype)
    y = _gate_norm(cfg, p, y, z, loc)
    return sharding.leave((y @ p["w_out"])[:, None], loc.split,
                          False), cache
