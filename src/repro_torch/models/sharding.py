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
``msize`` equal slices of every dim its spec names 'model'.  Attention
runs by hand on whole heads, where the reference's rule only asks that
``n_kv_heads * head_dim`` divide -- GSPMD may cut a head there, a manual
attention cannot.  So ``placement_specs`` keeps a layer's attention
leaves (q, k, v, o and their biases) replicated wherever the rule splits
them but ``n_heads`` or ``n_kv_heads`` is not a multiple of the group
(qwen2-7b's 28 / 4 heads at m = 8), and that attention runs unsplit on
every rank: ``whole_heads`` is that one rule.  A layer knows it holds a
shard from its local weight's width against the config's
(``holds_shard``), and a shard run with no model group active raises
rather than return its partial sums.

The collectives are Megatron's pair, each an ``autograd.Function`` with
``setup_context`` so that it runs under ``torch.func.grad`` (which hands
a Function's ``forward`` plain tensors: a collective on a grad-tracking
wrapper fails):

  ``copy_to_model``     forward identity, backward ``all_reduce`` -- where
                        a replicated activation enters a split layer
  ``reduce_from_model`` forward ``all_reduce``, backward identity -- where
                        a split layer's partial sums leave it

and ``all_reduce_max`` (no gradient) for the vocab-parallel loss;
``gather_shard`` assembles full-vocab logits and whole params.  A
replicated weight used inside a split layer (qk-norm scales, the MoE
routing weights) enters through ``copy_to_model`` too, so its gradient
is the sum of the ranks' parts.  Every rank of the group computes the
same loss, and the gradient of its shards is the whole gradient's slice.

The group comes from ``model_parallel(group)``, a context the step
factories (``fl.distributed``) enter around a model call: with no group,
or a group of one rank, every collective here is the identity and the
single-device path runs as before.  Activations are not
sequence-sharded: ``set_activation_sharding`` with an axis (SP-MLP) and
the expert-parallel MoE (``set_moe_sharding('expert')``) at a model
group above 1 raise ``NotImplementedError`` naming ROADMAP queue 1 item
13b-ii, as do MLA, SSD and the hybrid stack.
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
           "moe_expert_parallel", "set_activation_sharding", "sp_mlp_axis",
           "whole_heads", "holds_shard", "placement_specs", "local_shard",
           "gather_shard", "spec_leaves",
           "model_parallel", "model_group", "model_rank", "copy_to_model",
           "reduce_from_model", "all_reduce_max", "refuse", "ITEM_13B_II"]

ITEM_13B_II = "ROADMAP queue 1 item 13b-ii"

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
_ATTN_LEAF = re.compile(r"attn/(q|k|v|o)/(w|b)$")


def set_moe_sharding(kind: str) -> None:
    """'tensor' (default) or 'expert' -- switches the MoE weight rules."""
    global _MOE_EXPERT_PARALLEL
    _MOE_EXPERT_PARALLEL = (kind == "expert")


def moe_expert_parallel() -> bool:
    return _MOE_EXPERT_PARALLEL


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


def _spec_for(path_s: str, ndim: int, divisible) -> Spec:
    rules = ((_MOE_EXPERT_RULES + _RULES) if _MOE_EXPERT_PARALLEL
             else _RULES)
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


def set_activation_sharding(seq_axis: Optional[str],
                            sp_mlp: bool = False) -> None:
    """Sequence parallelism between blocks (and the SP-MLP) is not ported:
    ``None`` is the only setting."""
    if seq_axis is not None:
        raise NotImplementedError(
            f"sequence-parallel activations over {seq_axis!r} (SP-MLP, "
            f"the 'shardmap' client step) are not ported ({ITEM_13B_II})")


def sp_mlp_axis() -> Optional[str]:
    """The SP-MLP's axis: always None in the port."""
    return None


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def whole_heads(cfg, model_axis_size: int) -> bool:
    """Whether attention splits over a model group of ``model_axis_size``:
    only where both the q and the kv heads divide it (module docstring).
    ``placement_specs`` places by it, ``models.attention.local_heads``
    counts by it."""
    m = model_axis_size
    return (not cfg.n_heads
            or (cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0))


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
    """``param_specs`` with the attention leaves kept replicated where the
    heads do not split into whole heads (``whole_heads``)."""
    m = model_axis_size
    split_attn = whole_heads(cfg, m)

    def one(path_s, leaf):
        spec = _spec_for(path_s, leaf.ndim, lambda i: leaf.shape[i] % m == 0)
        if not split_attn and _ATTN_LEAF.search(path_s):
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


def refuse(what: str) -> None:
    """Raise for ``what`` when a model group above 1 is active."""
    if model_group() is not None:
        raise NotImplementedError(
            f"{what} with a 'model' group of {model_rank()[1]} ranks is not "
            f"ported ({ITEM_13B_II})")


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
