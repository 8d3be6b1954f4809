"""Mixture-of-Experts FFN: top-k router + grouped expert GEMMs (port of
``repro.models.moe``).

Two compute paths with the reference's semantics:

* ``ragged`` -- sort the (token, slot) pairs by expert (a stable sort, as
  the reference's ``jnp.argsort``) and run the three SwiGLU GEMMs over
  the expert-sorted rows, each expert on its own rows only
  (``expert_matmul``).  No token is dropped.  ``moe_chunk`` runs the
  dispatch a chunk of tokens at a time after routing all of them.
* ``dense`` -- the oracle: every expert on every token, combined with the
  routing weights.

The reference's ``jax.lax.ragged_dot`` is a library GEMM, not a Pallas
kernel; ``expert_matmul`` picks one of two library routes by a fixed
rule on dtype and device (``expert_route``): ``grouped_mm``
(``torch.nn.functional.grouped_mm``, one launch over all experts with
device-side offsets) for bf16 on the card, else ``loop`` (one
``torch.matmul`` per non-empty expert over its rows).  Both count their
launches in ``expert_matmul.routes``.  Inside ``torch.func.vmap``
(federated training batches the clients) neither can run --
``grouped_mm`` has no batching rule and the loop's row counts are
data-dependent shapes -- so there ``moe_apply`` takes the dense oracle
whatever ``moe_impl`` says.

The combine does not scatter-add: the weighted expert rows are un-sorted
back to (T, k, d) and summed over the k slots in slot order, one add at a
time in the activation dtype, so a call's result does not depend on the
order in which atomics land (``index_add_`` on the card), and a replay is
bitwise.

Tensor-parallel experts (the reference's default ``moe_sharding=
'tensor'``, ``models.sharding``): a rank holds every expert's slice of
the ffn dim (``gate`` / ``up`` columns, ``down`` rows).  The router runs
replicated on all tokens and computes the same fp32 ids on every rank;
the tokens and the routing weights enter the experts through
``copy_to_model``, both expert paths and the dense oracle run on the
local ffn slice, and one ``reduce_from_model`` follows the combine.  The
shared experts split like the MLP.  Under sequence parallelism the
tokens are gathered (``gather_seq``) in place of ``copy_to_model``, the
router reads them through ``own_rows_grad`` and the output is
reduce-scattered (``scatter_seq``).

Expert-parallel experts (``moe_sharding='expert'``, the expert axis
split, ``_moe_expert_parallel``): the reference's GShard capacity
dispatch, taken where a rank holds E/m whole experts.  The router runs on
all tokens; each slot's rank within its expert in token order (a stable
sort) decides whether it fits the capacity ``max(int(2 T k / E), 8)``, the
rest are dropped; each rank runs its experts on its (E/m, cap, d)
buffer; the combine adds each token's k slots in slot order in the
activation dtype, and one ``reduce_from_model`` of (T, d) sums the
ranks.  No float atomic: the buffer is filled by an index copy whose
only repeated target is a scratch row.  ``ep_stats`` counts the slots
and the dropped ones (one host sync a call).  Where expert-split weights
meet a config whose ``moe_sharding`` is 'tensor' (only the global
``set_moe_sharding('expert')`` set), the reference runs the drop-free
path on them under GSPMD; so does the port, each rank its own experts in
the dense form, summed.  Without a model group the reference takes the
ragged path even with ``moe_sharding='expert'``, and so does the port.

Shared experts (DeepSeek-V2) are a plain always-on SwiGLU branch.  The
auxiliary load-balance loss is the Switch/GShard form
``E * sum_e f_e * P_e``.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from . import sharding
from .config import ModelConfig
from .layers import lecun_normal, mlp_apply, mlp_init

PyTree = Any

__all__ = ["moe_init", "moe_apply", "expert_matmul", "expert_route",
           "ep_stats", "ep_stats_reset", "ROUTES"]

ROUTES = ("grouped_mm", "loop")


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> PyTree:
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts

    def experts(shape, fan_in):
        # lecun_normal normalizes by shape[0] = E; the reference rescales
        # to fan-in d / ff in the parameter dtype
        return lecun_normal(gen, shape, dtype).mul_(torch.tensor(
            math.sqrt(E / fan_in), dtype=torch.float32).to(dtype))

    p = {
        "router": lecun_normal(gen, (d, E), torch.float32),
        "gate": experts((E, d, ff), d),
        "up": experts((E, d, ff), d),
        "down": experts((E, ff, d), ff),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, cfg.n_shared_experts * ff, "swiglu",
                               dtype)
    return p


def _route(cfg: ModelConfig, p: PyTree, xf: torch.Tensor):
    """xf (T, d) -> weights (T, k) in xf's dtype, ids (T, k), aux_loss
    (fp32 scalar)."""
    E, k = cfg.n_experts, cfg.experts_per_token
    logits = xf.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, k, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True)
    # Switch-style load balance: f_e = E * token fraction routed to e
    # (the one-hot mean of the reference), P_e = mean router probability
    f = _counts(ids, E).float() / ids.numel() * E
    aux = (f * probs.mean(dim=0)).sum()
    return w.to(xf.dtype), ids, aux


def _counts(ids: torch.Tensor, E: int) -> torch.Tensor:
    """Slots routed to each expert, int64 (E,).  An out-of-place
    scatter-add of ones (``vmap`` batches it; the in-place form cannot
    take a batched index into an unbatched buffer): integer sums in any
    order are exact, and unlike ``bincount`` or ``one_hot`` on the card
    it does not sync the host."""
    flat = ids.reshape(-1)
    return torch.zeros(E, dtype=torch.int64, device=ids.device) \
        .scatter_add(0, flat, torch.ones_like(flat))


def _under_vmap() -> bool:
    """True inside a ``torch.func.vmap`` (at any nesting depth), read
    from functorch's interpreter stack: ``torch.func`` has no public
    query for it."""
    from torch._C._functorch import TransformType, get_interpreter_stack

    return any(i.key() == TransformType.Vmap
               for i in get_interpreter_stack() or ())


def expert_route(dtype: torch.dtype, device: torch.device) -> str:
    """The grouped GEMM's route, fixed by dtype and device:
    ``grouped_mm`` for bf16 on the card (the library's grouped kernel
    takes bf16 only), ``loop`` otherwise.  A batched input (inside
    ``torch.func.vmap``) takes neither: ``moe_apply`` sends it to the
    dense oracle, since ``grouped_mm`` has no batching rule and the
    loop's row counts are data-dependent shapes."""
    if device.type == "cuda" and dtype == torch.bfloat16:
        return "grouped_mm"
    return "loop"


def expert_matmul(xs: torch.Tensor, w: torch.Tensor, sizes: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """Grouped GEMM: rows ``xs`` (N, K) sorted by expert, ``sizes[e]``
    rows for expert e (int64, on xs's device) ending at ``offsets[e]``
    (int32 cumsum) -> (N, M) with rows of expert e times ``w[e]`` (K, M),
    in xs's dtype.  The reference's ``jax.lax.ragged_dot``."""
    route = expert_route(xs.dtype, xs.device)
    if route == "grouped_mm":
        out = F.grouped_mm(xs, w, offs=offsets)
        expert_matmul.routes[route] += 1
        return out
    parts, start = [], 0
    for e, n in enumerate(_host_sizes(sizes, xs.shape[0])):
        if n:
            parts.append(xs[start:start + n] @ w[e])
            expert_matmul.routes[route] += 1
        start += n
    return torch.cat(parts)


expert_matmul.routes = dict.fromkeys(ROUTES, 0)


def _abstract(t: torch.Tensor) -> bool:
    """A tensor without data: on the meta device or a ``FakeTensor``."""
    return t.is_meta or is_fake(t)


def _host_sizes(sizes: torch.Tensor, rows: int):
    """Each expert's row count on the host: one sync a call.  A dry-run's
    abstract tensors (``launch/dryrun.py``) hold no counts; they take the
    ``rows`` split as evenly as it goes, which gives every FLOP count the
    real routing gives (2 x rows x K x N over the experts, whatever the
    split)."""
    if _abstract(sizes):
        E = sizes.shape[0]
        return [rows // E + (e < rows % E) for e in range(E)]
    return sizes.tolist()


def _experts_ragged(p: PyTree, xs, sizes, offsets, dtype) -> torch.Tensor:
    """Grouped SwiGLU over expert-sorted rows xs (Tk, d)."""
    g = expert_matmul(xs, p["gate"], sizes, offsets)
    u = expert_matmul(xs, p["up"], sizes, offsets)
    h = (F.silu(g) * u).to(dtype)
    return expert_matmul(h, p["down"], sizes, offsets)


def _dispatch_ragged(cfg: ModelConfig, p: PyTree, xf, w, ids) -> torch.Tensor:
    """Expert dispatch + grouped GEMMs + combine for pre-routed tokens."""
    T, d = xf.shape
    k, E = cfg.experts_per_token, cfg.n_experts
    flat_ids = ids.reshape(-1)                           # (T*k,)
    order = torch.argsort(flat_ids, stable=True)
    xs = xf[order // k]                                  # (T*k, d)
    sizes = _counts(flat_ids, E)
    offsets = torch.cumsum(sizes, 0).to(torch.int32)
    ys = _experts_ragged(p, xs, sizes, offsets, xf.dtype)
    ys = ys * w.reshape(-1)[order][:, None].to(xf.dtype)
    # un-sort to (T, k, d) and add the k slots in a fixed order
    yk = torch.empty_like(ys)
    yk[order] = ys
    yk = yk.view(T, k, d)
    out = yk[:, 0]
    for j in range(1, k):
        out = out + yk[:, j]
    return out


def _moe_ragged(cfg: ModelConfig, p: PyTree, xs: torch.Tensor,
                xr: torch.Tensor, split: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router on ``xr``, the experts on ``xs`` (the same tokens, as
    ``sharding.layer_inputs`` gives them to split experts)."""
    T = xs.shape[0]
    w, ids, aux = _route(cfg, p, xr)                     # router on all tokens
    w = _weights_in(w, split)
    C = cfg.moe_chunk
    if not (C and T > C and T % C == 0):
        return _dispatch_ragged(cfg, p, xs, w, ids), aux
    # token-chunked dispatch: the (T*k, d) / (T*k, ff) buffers exist one
    # chunk at a time; routing is global, so this is exact
    outs = [_dispatch_ragged(cfg, p, xs[i:i + C], w[i:i + C], ids[i:i + C])
            for i in range(0, T, C)]
    return torch.cat(outs, dim=0), aux


def _weights_in(w: torch.Tensor, split: bool) -> torch.Tensor:
    """The routing weights as split experts read them: through
    ``copy_to_model``."""
    return sharding.copy_to_model(w) if split else w


def _moe_dense(cfg: ModelConfig, p: PyTree, xs: torch.Tensor,
               xr: torch.Tensor, split: bool, e0: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert of ``p`` (the config's experts ``e0 ..``) on every
    token, combined with the routing weights."""
    E = p["gate"].shape[0]
    w, ids, aux = _route(cfg, p, xr)
    w = _weights_in(w, split)
    # the one-hot by comparison: ``F.one_hot`` checks its ids on the
    # host, which ``vmap`` cannot batch
    onehot = (ids[..., None] == e0 + torch.arange(E, device=ids.device)) \
        .to(xs.dtype)                                    # (T, k, E)
    combine = torch.einsum("tk,tke->te", w, onehot)      # (T, E)
    ys = torch.stack([(F.silu(xs @ p["gate"][e]) * (xs @ p["up"][e]))
                      @ p["down"][e] for e in range(E)])  # (E, T, d)
    return torch.einsum("te,etd->td", combine, ys), aux


_EP_STATS = dict(slots=0, dropped=0, calls=0)


def ep_stats() -> dict:
    """Slots the expert-parallel path dispatched and dropped, and its
    calls, since ``ep_stats_reset`` (a rematerialised layer counts again
    when it is recomputed)."""
    return dict(_EP_STATS)


def ep_stats_reset() -> None:
    _EP_STATS.update(slots=0, dropped=0, calls=0)


def _moe_expert_parallel(cfg: ModelConfig, p: PyTree, xs: torch.Tensor,
                         xr: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard capacity dispatch on this rank's E/m experts (the
    reference's ``_moe_expert_parallel``): the router on all tokens
    (``xr``), the rank's experts on the tokens routed to them within
    capacity (``xs``), the combine in the activation dtype; the partial
    (T, d) output, summed over the group by the caller."""
    T, d = xs.shape
    k, E = cfg.experts_per_token, cfg.n_experts
    w, ids, aux = _route(cfg, p, xr)
    w = _weights_in(w, True)
    cap = max(int(2.0 * T * k / E), 8)

    flat_ids = ids.reshape(-1)                           # (T*k,)
    # the rank of each slot within its expert, in token order (a stable
    # sort, as the reference's jnp.argsort)
    order = torch.argsort(flat_ids, stable=True)
    sizes = _counts(flat_ids, E)
    starts = torch.cumsum(sizes, 0) - sizes
    rank_sorted = torch.arange(T * k, device=xs.device) \
        - starts[flat_ids[order]]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = rank < cap
    _EP_STATS["slots"] += T * k
    # a dry-run's abstract tensors hold no routing: no slot counts as
    # dropped
    _EP_STATS["dropped"] += 0 if _abstract(keep) else int((~keep).sum())
    _EP_STATS["calls"] += 1

    E_loc = p["gate"].shape[0]
    e_loc = flat_ids - sharding.model_rank()[0] * E_loc
    mine = keep & (e_loc >= 0) & (e_loc < E_loc)
    # one buffer row a (local expert, capacity slot), plus a scratch row
    # that every slot not dispatched here writes: an index copy, no
    # atomic (a kept slot's row is its own)
    dest = torch.where(mine, e_loc.clamp(0, E_loc - 1) * cap
                       + rank.clamp(0, cap - 1), E_loc * cap)
    slot_tok = torch.arange(T * k, device=xs.device) // k
    buf = xs.new_zeros((E_loc * cap + 1, d)).index_copy(0, dest,
                                                         xs[slot_tok])
    buf = buf[:-1].view(E_loc, cap, d)
    h = F.silu(torch.bmm(buf, p["gate"])) * torch.bmm(buf, p["up"])
    y = torch.bmm(h.to(xs.dtype), p["down"]).reshape(E_loc * cap, d)
    back = y[dest.clamp(max=E_loc * cap - 1)]            # (T*k, d)
    contrib = (back * (w.reshape(-1) * mine.to(w.dtype))[:, None]) \
        .to(xs.dtype).view(T, k, d)
    # each token's k slots added in slot order, in the activation dtype
    out = torch.zeros((T, d), dtype=xs.dtype, device=xs.device) \
        + contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out, aux


def moe_apply(cfg: ModelConfig, p: PyTree, x: torch.Tensor,
              seq: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux_loss fp32 scalar).  The ragged
    path unless ``cfg.moe_impl`` is 'dense' or this runs inside
    ``torch.func.vmap`` (``expert_route``); the expert-parallel path where
    the rank holds whole experts and ``cfg.moe_sharding`` is 'expert'.
    ``seq``: ``x`` is the rank's rows of the sequence (sequence
    parallelism), and so is ``y``; the router and the experts see every
    token."""
    expert_split = sharding.holds_shard(p["gate"].shape[0], cfg.n_experts)
    split = expert_split or sharding.holds_shard(p["gate"].shape[-1],
                                                 cfg.moe_d_ff)
    B, _, d = x.shape
    if split:
        xs, xr = sharding.layer_inputs(x, seq)
    else:
        xs = xr = sharding.enter(x, False, seq)
    S = xs.shape[1]
    xs, xr = xs.reshape(B * S, d), xr.reshape(B * S, d)
    if expert_split and cfg.moe_sharding == "expert":
        out, aux = _moe_expert_parallel(cfg, p, xs, xr)
    elif expert_split:
        out, aux = _moe_dense(cfg, p, xs, xr, True,
                              e0=sharding.model_rank()[0] * p["gate"].shape[0])
    elif cfg.moe_impl == "ragged" and not _under_vmap():
        out, aux = _moe_ragged(cfg, p, xs, xr, split)
    else:
        out, aux = _moe_dense(cfg, p, xs, xr, split)
    out = sharding.leave(out.reshape(B, S, d), split, seq)
    if cfg.n_shared_experts:
        out = out + mlp_apply(p["shared"], x, "swiglu",
                              cfg.n_shared_experts * cfg.moe_d_ff, seq)
    return out, aux
