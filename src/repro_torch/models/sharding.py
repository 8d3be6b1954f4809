"""Tensor parallelism inside a client: the sharding rules over the 'model'
mesh axis and the model group's collectives (port of
``repro.models.sharding``, plus the collectives GSPMD inserts there).

The rules map a parameter's tree path (``core.pytree``'s sorted keys,
'/'-joined: ``decoder/layers/attn/q/w``) to a spec over the leaf's own
dims, a tuple of axis names and ``None`` (the reference's
``PartitionSpec`` as a tuple); a stacked layer leaf gets leading
``None``s, and 'model' is dropped from a dim it does not divide.
``param_specs`` / ``cache_specs`` are the reference's functions and equal
its specs.

The port places the leaves itself (``placement_specs``, ``local_shard``,
``gather_shard``): a rank of the model group holds the ``rank``-th of
``msize`` equal slices of every dim its spec names 'model'.  The layers
run by hand on whole heads, where the reference's rule only asks that a
width divide -- GSPMD may cut a head there, a manual layer cannot.  So
``placement_specs`` differs from ``param_specs`` in three places:

  * attention (GQA and MLA) stays replicated wherever ``n_heads`` or
    ``n_kv_heads`` is not a multiple of the group (qwen2-7b's 28 / 4 heads
    at m = 8), and runs unsplit on every rank (``whole_heads``);
  * the SSD block stays replicated wherever its heads do not divide
    (``ssd_splits``), and its ``w_B`` / ``w_C`` stay whole wherever its
    groups do not (``whole_groups``: the rule would cut mamba2's and
    zamba2's one group, G = 1, through the state dim N, which a manual
    SSD cannot score without a reduction inside every score);
  * the MoE experts split by the expert axis (``_MOE_EXPERT_RULES``)
    when ``set_moe_sharding('expert')`` or the config's
    ``moe_sharding == 'expert'``.

A layer knows it holds a shard from its local weight's width against the
config's (``holds_shard``), and a shard run with no model group active
raises rather than return its partial sums.

The collectives are ``autograd.Function``s with ``setup_context``, so
that they run under ``torch.func.grad`` (which hands a Function's
``forward`` plain tensors: a collective on a grad-tracking wrapper
fails).  Megatron's pair:

  ``copy_to_model``     forward identity, backward ``all_reduce`` -- where
                        a replicated activation enters a split layer
  ``reduce_from_model`` forward ``all_reduce``, backward identity -- where
                        a split layer's partial sums leave it
  ``all_reduce_both``   ``all_reduce`` both ways -- a sum every rank's
                        loss reads, built from the ranks' parts (the
                        split RMSNorm's sum of squares)

and ``all_reduce_max`` (no gradient) for the vocab-parallel loss;
``gather_shard`` assembles full-vocab logits and whole params.  A
replicated tensor used inside a split layer (qk-norm scales, MLA's
latents, the SSD's ``B`` / ``C``, the MoE routing weights) enters
through ``copy_to_model`` too, so its gradient is the sum of the ranks'
parts.  Every rank of the group computes the same loss, and the
gradient of its shards is the whole gradient's slice.

Sequence parallelism (``set_activation_sharding('model')``, the
reference's ``constrain_seq``): between blocks a rank holds its 1/m of
the sequence rows of the residual stream, the norms run on those rows
(their scales through ``copy_to_model``: each rank's rows give a part of
their gradient), and a layer's input is gathered where the reference's
GSPMD inserts the all-gather:

  ``gather_seq``   forward all-gather along the sequence, backward
                   reduce-scatter -- the input of a split layer
  ``scatter_seq``  forward reduce-scatter, backward all-gather -- the
                   split layer's partial sums, back to the rank's rows
  ``split_seq``    forward the rank's rows, backward all-gather -- a
                   replicated result (the embedding, a layer that runs
                   whole) back to the rank's rows
  ``own_rows_grad`` forward identity, backward the gradient of the
                   rank's rows only -- the gathered input of replicated
                   compute (a router, a latent projection), which every
                   rank runs on all rows: the reduce-scatter behind it
                   then counts that compute once

``layer_inputs`` / ``enter`` / ``leave`` pick between these and
Megatron's pair, one rule for every layer.  ``gather_seq`` /
``scatter_seq`` / ``split_seq`` take one of two routes, chosen from the
group's backend and the tensor's device (``seq_route``): 'collective'
(``all_gather_into_tensor`` / ``reduce_scatter_tensor``: NCCL on cards,
gloo on the CPU) or 'broadcast' (m ``broadcast``s / an ``all_reduce``
and the rank's slice: gloo with CUDA tensors, which runs those two
only).  Any other pairing raises.

The group comes from ``model_parallel(group)``, a context the step
factories (``fl.distributed``) enter around a model call: with no group,
or a group of one rank, every collective here is the identity and the
single-device path runs as before.
"""

from __future__ import annotations

import re
from contextlib import contextmanager
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.pytree import tree_flatten, tree_unflatten

PyTree = Any
Spec = Tuple

__all__ = ["param_specs", "cache_specs", "set_moe_sharding",
           "set_activation_sharding", "sp_mlp_axis", "seq_parallel",
           "whole_heads", "ssd_splits", "whole_groups", "expert_rules",
           "holds_shard", "placement_specs", "local_shard", "gather_shard",
           "spec_leaves", "model_parallel", "model_group", "model_rank",
           "copy_to_model", "reduce_from_model", "all_reduce_both",
           "all_reduce_max", "seq_route", "gather_seq", "scatter_seq",
           "split_seq", "own_rows_grad", "layer_inputs", "enter", "leave",
           "seq_weight"]

# path-regex -> spec over the parameter's own dims (a stacked leaf's layer
# axes are prepended as None)
_RULES: Tuple[Tuple[str, Spec], ...] = (
    # embeddings / head
    (r"embed$",                      ("model", None)),
    (r"lm_head$",                    (None, "model")),
    (r"frontend_proj$",              (None, None)),
    (r"final_norm$",                 (None,)),
    # attention (GQA)
    (r"attn/(q|k|v)/w$",             (None, "model")),
    (r"attn/(q|k|v)/b$",             ("model",)),
    (r"attn/o/w$",                   ("model", None)),
    (r"attn/(q_norm|k_norm)$",       (None,)),
    # MLA
    (r"mla/wq_a$",                   (None, None)),
    (r"mla/wq_b$",                   (None, "model")),
    (r"mla/wq$",                     (None, "model")),
    (r"mla/wkv_a$",                  (None, None)),
    (r"mla/wkv_b$",                  (None, "model")),
    (r"mla/wo$",                     ("model", None)),
    (r"mla/(q_norm|kv_norm)$",       (None,)),
    # dense MLP
    (r"mlp/(gate|up)$",              (None, "model")),
    (r"mlp/down$",                   ("model", None)),
    # MoE, tensor-parallel experts (the ffn dim split)
    (r"moe/router$",                 (None, None)),
    (r"moe/(gate|up)$",              (None, None, "model")),
    (r"moe/down$",                   (None, "model", None)),
    (r"moe/shared/(gate|up)$",       (None, "model")),
    (r"moe/shared/down$",            ("model", None)),
    # SSM (mamba2)
    (r"ssm/(w_x|w_z|w_B|w_C|w_dt)$", (None, "model")),
    (r"ssm/(dt_bias|A_log|D)$",      ("model",)),
    (r"ssm/conv_(w|b)$",             ()),
    (r"ssm/gate_norm$",              ("model",)),
    (r"ssm/w_out$",                  ("model", None)),
    # norms
    (r"ln\d$",                       (None,)),
)

_MOE_EXPERT_RULES: Tuple[Tuple[str, Spec], ...] = (
    # expert-parallel: the expert axis split (moe_sharding='expert')
    (r"moe/(gate|up|down)$",         ("model", None, None)),
)

_MOE_EXPERT_PARALLEL = False
# the leaves a layer runs split by whole heads (attention, MLA) or whole
# SSD heads / groups; kept replicated where those do not divide
_ATTN_LEAF = re.compile(r"(attn/(q|k|v|o)/(w|b)|mla/(wq_b|wq|wkv_b|wo))$")
_SSD_LEAF = re.compile(r"ssm/(w_x|w_z|w_dt|dt_bias|A_log|D|gate_norm|w_out)$")
_SSD_GROUP_LEAF = re.compile(r"ssm/(w_B|w_C)$")


def set_moe_sharding(kind: str) -> None:
    """'tensor' (default) or 'expert' -- switches the MoE weight rules."""
    global _MOE_EXPERT_PARALLEL
    _MOE_EXPERT_PARALLEL = (kind == "expert")


def _paths(tree: PyTree, prefix: str = "") -> List[str]:
    """Leaf paths in ``tree_flatten`` order; a tuple is a leaf (a spec)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _paths(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, list):
        out = []
        for i, c in enumerate(tree):
            out += _paths(c, f"{prefix}{i}/")
        return out
    return [prefix[:-1]]


def spec_leaves(specs: PyTree) -> List[Spec]:
    """A spec tree's specs in ``tree_flatten`` order of its params."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for c in specs for s in spec_leaves(c)]
    return [specs]


def _map_specs(fn: Callable[[str, Any], Spec], tree: PyTree) -> PyTree:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(p, leaf) for p, leaf in
                                    zip(_paths(tree), leaves)])


def _spec_for(path_s: str, ndim: int, divisible,
              expert: Optional[bool] = None) -> Spec:
    if expert is None:
        expert = _MOE_EXPERT_PARALLEL
    rules = (_MOE_EXPERT_RULES + _RULES) if expert else _RULES
    for pat, spec in rules:
        if re.search(pat, path_s):
            spec_t = tuple(spec)
            if len(spec_t) < ndim:                 # stacked layer axes
                spec_t = (None,) * (ndim - len(spec_t)) + spec_t
            # 'model' is dropped from dims the axis size does not divide
            return tuple(s if not (s == "model" and not divisible(i))
                         else None for i, s in enumerate(spec_t))
    return (None,) * ndim


def _canonical(entry):
    """A spec entry as ``PartitionSpec`` keeps it: a one-axis tuple is the
    axis name."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else entry
    return entry


def param_specs(params: PyTree, model_axis_size: int,
                prefix: Tuple = ()) -> PyTree:
    """The spec tree of ``params`` (tuples as leaves); ``prefix`` is
    prepended to every spec (``(('pod', 'data'),)`` for per-client
    stacked parameters)."""
    def one(path_s, leaf):
        spec = _spec_for(path_s, leaf.ndim,
                         lambda i: leaf.shape[i] % model_axis_size == 0)
        return tuple(_canonical(a) for a in prefix) + spec

    return _map_specs(one, params)


def cache_specs(cache: PyTree, batch_axes, model_axis_size: int) -> PyTree:
    """The reference's decode-cache specs: batch over ``batch_axes``, the
    cache's sequence dim over 'model' (a context-parallel cache), small
    leaves replicated.  The port's cache splits the kv heads instead
    (``models.attention.make_kv_cache`` on a rank's heads): the same
    bytes a rank where the heads divide, the whole cache where they do
    not."""
    batch_axes = _canonical(batch_axes)

    def one(path_s, leaf):
        name = path_s.split("/")[-1]
        if name in ("k", "v"):
            spec = [None, batch_axes, "model", None, None]
        elif name in ("ckv", "krope"):
            spec = [None, batch_axes, "model", None]
        elif name == "kpos":
            spec = [None, "model"]
        elif name == "conv":
            spec = [None, batch_axes, None, "model"]
        elif name == "state":
            spec = [None, batch_axes, "model", None, None]
        else:
            spec = [None] * leaf.ndim
        spec = spec[:leaf.ndim] + [None] * (leaf.ndim - len(spec))
        return tuple(s if not (s == "model"
                               and leaf.shape[i] % model_axis_size)
                     else None for i, s in enumerate(spec))

    return _map_specs(one, cache)


_ACT_SEQ_AXIS: Optional[str] = None
_SP_MLP = False


def set_activation_sharding(seq_axis: Optional[str],
                            sp_mlp: bool = False) -> None:
    """Sequence parallelism between blocks over ``seq_axis`` ('model' or
    None), and the explicit SP-MLP (``layers.mlp_apply_sp``) with it;
    ``sp_mlp`` counts only with an axis, as in the reference."""
    global _ACT_SEQ_AXIS, _SP_MLP
    if seq_axis not in (None, "model"):
        raise ValueError(f"sequence parallelism runs over the 'model' axis "
                         f"(the model group), not {seq_axis!r}")
    _ACT_SEQ_AXIS = seq_axis
    _SP_MLP = bool(sp_mlp and seq_axis)


def sp_mlp_axis() -> Optional[str]:
    """Axis for the explicit SP-MLP (None = disabled)."""
    return _ACT_SEQ_AXIS if _SP_MLP else None


def seq_parallel(S: int) -> bool:
    """Whether a full-sequence pass of ``S`` positions runs sequence
    parallel: an axis is set and a model group above 1 is active.  Then
    S must split into the group's equal row blocks."""
    if _ACT_SEQ_AXIS is None or model_group() is None:
        return False
    m = model_rank()[1]
    if S % m:
        raise ValueError(f"sequence parallelism over a model group of {m} "
                         f"ranks needs a sequence that {m} divides; S = {S}")
    return True


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def whole_heads(cfg, model_axis_size: int) -> bool:
    """Whether attention (GQA or MLA) splits over a model group of
    ``model_axis_size``: only where both the q and the kv heads divide it
    (module docstring).  ``placement_specs`` places by it,
    ``models.attention.local_heads`` counts by it."""
    m = model_axis_size
    return (not cfg.n_heads
            or (cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0))


def ssd_splits(cfg, model_axis_size: int) -> bool:
    """Whether the SSD block's heads (its x / z / dt columns, per-head
    parameters, gate-norm slice and ``w_out`` rows) split into whole heads
    over the group."""
    return cfg.ssm_heads % model_axis_size == 0


def whole_groups(cfg, model_axis_size: int) -> bool:
    """Whether the SSD's ``w_B`` / ``w_C`` split into whole groups over the
    group (the SSD twin of ``whole_heads``): its heads split and
    ``ssm_groups`` divides.  Where not, they stay whole on every rank and
    each rank's heads read the whole ``B`` / ``C``."""
    m = model_axis_size
    return ssd_splits(cfg, m) and cfg.ssm_groups % m == 0


def expert_rules(cfg) -> bool:
    """Whether the MoE weights split by the expert axis: the global
    setting (``set_moe_sharding('expert')``) or the config's."""
    return _MOE_EXPERT_PARALLEL or getattr(cfg, "moe_sharding",
                                           "tensor") == "expert"


def holds_shard(local: int, whole: int) -> bool:
    """Whether a layer's weight of width ``local`` (its split dim) is a
    tensor-parallel shard of the config's ``whole`` width.  A shard runs
    only inside ``model_parallel``: with no group its partial sums would
    leave the layer as they are, so that raises."""
    if local == whole:
        return False
    _need_group()
    return True


def placement_specs(params: PyTree, cfg, model_axis_size: int) -> PyTree:
    """``param_specs`` with the leaves of a layer that runs by whole heads
    kept replicated where its heads do not split (``whole_heads``,
    ``ssd_splits``, ``whole_groups``), and the expert rules where
    ``expert_rules(cfg)`` (module docstring).  ``param_specs`` stays the
    reference's."""
    m = model_axis_size
    split_attn = whole_heads(cfg, m)
    split_ssd = ssd_splits(cfg, m) if cfg.family in ("ssm", "hybrid") \
        else True
    split_groups = whole_groups(cfg, m) if cfg.family in ("ssm", "hybrid") \
        else True
    expert = expert_rules(cfg)

    def one(path_s, leaf):
        spec = _spec_for(path_s, leaf.ndim, lambda i: leaf.shape[i] % m == 0,
                         expert)
        if (not split_attn and _ATTN_LEAF.search(path_s)) or \
                (not split_ssd and _SSD_LEAF.search(path_s)) or \
                (not split_groups and _SSD_GROUP_LEAF.search(path_s)):
            return (None,) * leaf.ndim
        return spec

    return _map_specs(one, params)


def local_shard(leaf: torch.Tensor, spec: Spec, rank: int, msize: int
                ) -> torch.Tensor:
    """The ``rank``-th of ``msize`` equal slices of ``leaf`` along the dim
    ``spec`` names 'model' (the leaf itself where none does), contiguous."""
    if msize == 1 or "model" not in spec:
        return leaf
    dim = spec.index("model")
    return leaf.chunk(msize, dim)[rank].contiguous()


def gather_shard(local: torch.Tensor, spec: Spec, group, msize: int
                 ) -> torch.Tensor:
    """Inverse of ``local_shard`` over the model ``group``: every rank
    gets the whole tensor, bit for bit (each rank broadcasts its slice in
    turn: gloo takes CUDA tensors for ``broadcast``, not for
    ``all_gather``).  For outputs and params, no gradient."""
    if msize == 1 or "model" not in spec:
        return local
    dim = spec.index("model")
    parts = []
    for r in range(msize):
        part = local.contiguous() if dist.get_rank(group) == r \
            else torch.empty_like(local, memory_format=torch.contiguous_format)
        dist.broadcast(part, dist.get_global_rank(group, r), group=group)
        parts.append(part)
    return torch.cat(parts, dim)


# ---------------------------------------------------------------------------
# the model group and its collectives
# ---------------------------------------------------------------------------

# the group the model's layers run their collectives on; a module global,
# not a thread-local, because autograd runs a CUDA backward (and the
# recomputation of a rematerialised layer in it) on its own thread
_GROUP = None


@contextmanager
def model_parallel(group):
    """Run the model's layers on ``group`` (None: no tensor parallelism)."""
    global _GROUP
    prev, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = prev


def model_group():
    """The current model group, or None without one (or with one rank)."""
    if _GROUP is None or dist.get_world_size(_GROUP) == 1:
        return None
    return _GROUP


def model_rank() -> Tuple[int, int]:
    """(this rank's index in the model group, the group's size)."""
    g = model_group()
    if g is None:
        return 0, 1
    return dist.get_rank(g), dist.get_world_size(g)


def _need_group():
    g = model_group()
    if g is None:
        raise RuntimeError(
            "a layer holds a tensor-parallel shard but no model group is "
            "active: run it inside sharding.model_parallel(group)")
    return g


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ReduceFromModel.apply(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceMax(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; its gradient is all-reduced over the model group
    (the input of a split layer)."""
    g = model_group()
    return x if g is None else _CopyToModel.apply(x, g)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """All-reduce (sum) over the model group; identity gradient (the
    output of a split layer)."""
    g = model_group()
    return x if g is None else _ReduceFromModel.apply(x, g)


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """Element-wise max over the model group, no gradient."""
    return _AllReduceMax.apply(x.detach(), _need_group())


class _AllReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _AllReduceBoth.apply(g, ctx.group), None


def all_reduce_both(x: torch.Tensor) -> torch.Tensor:
    """All-reduce (sum) over the model group, and its gradient too:
    ``reduce_from_model(copy_to_model(x))``.  For a sum every rank's loss
    reads, built from the ranks' parts (the split RMSNorm's sum of
    squares): its gradient on a rank is the sum of the ranks' parts."""
    g = model_group()
    return x if g is None else _AllReduceBoth.apply(x, g)


# ---------------------------------------------------------------------------
# sequence parallelism: the residual stream's rows split over the group
# ---------------------------------------------------------------------------

def seq_route(group, x: torch.Tensor) -> str:
    """The route of the sequence collectives for ``x`` on ``group``:
    'collective' (``all_gather_into_tensor`` / ``reduce_scatter_tensor``)
    for NCCL with CUDA tensors and gloo with CPU tensors, 'broadcast'
    (``broadcast`` / ``all_reduce`` and a slice) for gloo with CUDA
    tensors, which runs only those two.  A dry-run's fake group
    (``launch/dryrun.py``) takes the production route, NCCL's
    'collective'.  Any other pairing raises."""
    backend = str(dist.get_backend(group))
    if (backend == "nccl" and x.is_cuda) or (backend == "gloo"
                                             and not x.is_cuda) \
            or "fake" in backend:
        return "collective"
    if backend == "gloo" and x.is_cuda:
        return "broadcast"
    raise ValueError(f"no sequence-collective route for a {x.device.type} "
                     f"tensor on a {backend!r} group")


def _gather_rows(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``dim`` concatenated in rank order."""
    m = dist.get_world_size(group)
    if seq_route(group, x) == "broadcast":
        parts = []
        for r in range(m):
            part = x.contiguous() if dist.get_rank(group) == r \
                else torch.empty_like(x, memory_format=torch.contiguous_format)
            dist.broadcast(part, dist.get_global_rank(group, r), group=group)
            parts.append(part)
        return torch.cat(parts, dim)
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((m * front.shape[0],) + tuple(front.shape[1:]))
    dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim)


def _reduce_scatter_rows(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's block of ``dim``."""
    m, r = dist.get_world_size(group), dist.get_rank(group)
    if seq_route(group, x) == "broadcast":
        total = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(total, group=group)
        return total.chunk(m, dim)[r].contiguous()
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // m,) + tuple(front.shape[1:]))
    dist.reduce_scatter_tensor(out, front, group=group)
    return out.movedim(0, dim)


def _own_rows(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    m, r = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(m, dim)[r]


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(x, group, dim):
        return _gather_rows(x, dim, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _ScatterSeq.apply(g, ctx.group, ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(x, group, dim):
        return _reduce_scatter_rows(x, dim, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _GatherSeq.apply(g, ctx.group, ctx.dim), None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(x, group, dim):
        return _own_rows(x, dim, group).contiguous()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g, ctx.dim, ctx.group), None, None


class _OwnRowsGrad(torch.autograd.Function):
    @staticmethod
    def forward(x, group, dim):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        m, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        n = g.shape[ctx.dim] // m
        own = (torch.arange(g.shape[ctx.dim], device=g.device) // n) == r
        own = own.view((-1,) + (1,) * (g.ndim - 1 - ctx.dim % g.ndim))
        return torch.where(own, g, torch.zeros((), dtype=g.dtype,
                                               device=g.device)), None, None


def gather_seq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """All-gather the rank's rows of ``dim`` over the model group;
    gradient reduce-scattered (the input of a split layer under sequence
    parallelism, in place of ``copy_to_model``).  Route: ``seq_route``."""
    g = model_group()
    return x if g is None else _GatherSeq.apply(x, g, dim)


def scatter_seq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Reduce-scatter over the model group, the rank's rows of ``dim``;
    gradient all-gathered (a split layer's partial sums under sequence
    parallelism, in place of ``reduce_from_model``).  Route:
    ``seq_route``."""
    g = model_group()
    return x if g is None else _ScatterSeq.apply(x, g, dim)


def split_seq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The rank's rows of a replicated ``x``; gradient all-gathered (a
    replicated result back into the sequence-split stream).  Route:
    ``seq_route``."""
    g = model_group()
    return x if g is None else _SplitSeq.apply(x, g, dim)


def own_rows_grad(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Identity; the gradient keeps the rank's rows of ``dim`` only.  On
    a gathered input that every rank computes with whole (module
    docstring), so that ``gather_seq``'s reduce-scatter counts that
    compute's gradient once."""
    g = model_group()
    return x if g is None else _OwnRowsGrad.apply(x, g, dim)


def layer_inputs(x: torch.Tensor, seq: bool):
    """(the input of a layer's split compute, the input of its replicated
    compute) from the layer input ``x``: ``(copy_to_model(x), x)``, or
    under sequence parallelism (``x`` the rank's rows) the gathered rows
    ``(xg, own_rows_grad(xg))`` with ``xg = gather_seq(x)``.  A layer that
    runs whole reads the second only."""
    if not seq:
        return copy_to_model(x), x
    xg = gather_seq(x)
    return xg, own_rows_grad(xg)


def enter(x: torch.Tensor, split: bool, seq: bool) -> torch.Tensor:
    """The input of a layer that runs all split (``split``) or all whole:
    the first or the second of ``layer_inputs``, ``x`` itself for a whole
    layer without sequence parallelism."""
    if not (split or seq):
        return x
    return layer_inputs(x, seq)[0 if split else 1]


def leave(y: torch.Tensor, split: bool, seq: bool) -> torch.Tensor:
    """A layer's output back in the residual stream: a split layer's
    partial sums summed over the group -- the rank's rows under sequence
    parallelism (``scatter_seq``), all of them otherwise
    (``reduce_from_model``); a layer that ran whole on every rank as it
    is, or its rank's rows under sequence parallelism (``split_seq``)."""
    if split:
        return scatter_seq(y) if seq else reduce_from_model(y)
    return split_seq(y) if seq else y


def seq_weight(w: torch.Tensor, seq: bool) -> torch.Tensor:
    """A replicated weight applied to the rank's rows alone (a norm's
    scale under sequence parallelism) enters through ``copy_to_model``:
    each rank's rows give a part of its gradient."""
    return copy_to_model(w) if seq else w
