"""Decoder blocks and layer stacks for every architecture family (port of
``repro.models.blocks``): the transformer families (``dense``, ``moe``,
``audio``, ``vlm``; GQA or MLA attention, an MLP or an MoE FFN), the
attention-free ``ssm`` stack of Mamba2 blocks, and the ``hybrid`` stack
(zamba2: Mamba2 blocks with one shared transformer block applied after
every ``hybrid_attn_every`` of them).

Layer parameters are *stacked* (a leading ``n_layers`` axis on every
leaf, the reference's tree), so parameter trees carry across from the
JAX package unchanged (``models.convert.params_from_numpy``).  The
reference's ``jax.lax.scan`` over layers is a Python loop over views of
the stacked leaves.  ``cfg.remat`` checkpoints each stacked layer's body
(zamba2: each group's body), as the reference's ``jax.checkpoint`` does
(``models.remat``: only a body's inputs are kept, and the body is
recomputed in the backward pass).
Heterogeneous pieces sit outside the stack, as in the reference:
DeepSeek's leading dense layer(s) (``dense_layers``, a list of per-layer
trees with caches of their own) and zamba2's shared block (``shared``,
one tree reused by every group, with one KV cache a group).

Three entry points serve ``model.py``:
  * ``stack_forward``  -- full-sequence scoring, returns the MoE aux loss
                          summed over the stacked layers (0 without MoE)
  * ``stack_prefill``  -- forward + per-layer cache entries (stacked)
  * ``stack_decode``   -- one-token step through the per-layer caches

As in the reference, prefill attends with the plain ``_sdpa`` whatever
``cfg.attn_impl`` is, unless the caller asks for ``flash`` (the mesh
prefill step does); ``stack_forward`` reaches the flash kernel with
``cfg.attn_impl == 'flash'``.

Under a model group (``models.sharding``) every block runs on a rank's
tensor-parallel shards: attention and MLA by whole heads, the Mamba2
block by whole SSD heads, the MLP by ffn columns, the MoE experts by ffn
columns or, expert-parallel, by whole experts; zamba2's shared block
splits like any transformer block.  With ``seq`` (sequence parallelism,
``sharding.seq_parallel``: the reference's ``constrain_seq`` around every
block) the residual stream between blocks is the rank's rows of the
sequence: the norms run on those rows, attention, MLA, the SSD and the
MoE gather their input and reduce-scatter their output
(``sharding.enter`` / ``leave``), and a SwiGLU MLP is the explicit
``mlp_apply_sp``.  The forward and the prefill take ``seq``; a decode
step (one position) runs plain tensor parallelism.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.core.pytree import tree_flatten, tree_map, tree_unflatten
from . import attention as attn
from . import mla as mla_mod
from . import moe as moe_mod
from . import sharding
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import mlp_apply, mlp_apply_sp, mlp_init, norm
from .remat import remat

PyTree = Any

__all__ = ["stack_init", "stack_forward", "stack_prefill", "stack_decode",
           "transformer_block_init", "mamba_block_init"]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def transformer_block_init(gen: torch.Generator, cfg: ModelConfig, dtype,
                           is_moe: bool = False) -> PyTree:
    ones = torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)
    p = {"ln1": ones, "ln2": ones.clone()}
    if cfg.mla:
        p["mla"] = mla_mod.mla_init(gen, cfg, dtype)
    else:
        p["attn"] = attn.attn_init(gen, cfg, dtype)
    if is_moe:
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype)
    return p


def mamba_block_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> PyTree:
    return {"ln1": torch.ones((cfg.d_model,), dtype=dtype,
                              device=gen.device),
            "ssm": ssm_mod.ssm_init(gen, cfg, dtype)}


def _stacked(n: int, make: Callable[[], PyTree]) -> PyTree:
    """``n`` draws of ``make()`` stacked leaf-wise along a new leading
    axis, written into the stacked leaves one layer at a time: besides
    the stack, one layer's draw is alive at a time."""
    leaves, treedef = tree_flatten(make())
    out = [torch.empty((n,) + tuple(a.shape), dtype=a.dtype, device=a.device)
           for a in leaves]
    for i in range(n):
        if i:
            leaves = tree_flatten(make())[0]
        for o, a in zip(out, leaves):
            o[i] = a
        del leaves
    return tree_unflatten(treedef, out)


def stack_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> PyTree:
    """All decoder-layer parameters (embed/head live in model.py)."""
    if cfg.family in ("ssm", "hybrid"):
        out = {"layers": _stacked(
            cfg.n_layers, lambda: mamba_block_init(gen, cfg, dtype))}
        if cfg.family == "hybrid":
            out["shared"] = transformer_block_init(gen, cfg, dtype)
        return out
    out = {}
    if cfg.first_dense_layers:
        out["dense_layers"] = [transformer_block_init(gen, cfg, dtype)
                               for _ in range(cfg.first_dense_layers)]
    out["layers"] = _stacked(
        cfg.n_layers - cfg.first_dense_layers,
        lambda: transformer_block_init(gen, cfg, dtype, cfg.n_experts > 0))
    return out


def _layer(tree: PyTree, i: int) -> PyTree:
    return tree_map(lambda a: a[i], tree)


def _unstacked(tree: PyTree):
    """The per-layer trees of stacked leaves, by ``torch.unbind``: its
    backward stacks the layers' grads once, where indexing layer by layer
    would give each layer's grad a zero-filled copy of the whole stack (a
    full stacked leaf per layer and leaf under ``grad``)."""
    leaves, treedef = tree_flatten(tree)
    cols = [torch.unbind(a, 0) for a in leaves]
    return [tree_unflatten(treedef, list(layer)) for layer in zip(*cols)]


def hybrid_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """zamba2's layout: (n_groups, every) with n_layers = n_groups * every
    (the reference reshapes the stacked layers to it)."""
    every = cfg.hybrid_attn_every
    n_groups = max(cfg.n_layers // every, 1)
    if n_groups * every != cfg.n_layers:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of hybrid_attn_every {every}")
    return n_groups, every


# ---------------------------------------------------------------------------
# Per-layer forward / prefill / decode
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig, x, scale, seq: bool):
    """A block's norm, on the rank's rows under ``seq`` (its scale through
    ``sharding.seq_weight``)."""
    return norm(x, sharding.seq_weight(scale, seq), cfg.norm_type,
                cfg.norm_eps)


def _ffn_half(cfg: ModelConfig, p: PyTree, x: torch.Tensor,
              seq: bool = False):
    """x + FFN(norm(x)) -> (x, aux or None): the MoE FFN where the layer
    has one, else the MLP (``mlp_apply_sp`` for SwiGLU under ``seq``)."""
    h = _norm(cfg, x, p["ln2"], seq)
    if "moe" in p:
        y, aux = moe_mod.moe_apply(cfg, p["moe"], h, seq)
        return x + y, aux
    if seq and cfg.mlp_type == "swiglu":
        return x + mlp_apply_sp(p["mlp"], h, d_ff=cfg.d_ff), None
    return x + mlp_apply(p["mlp"], h, cfg.mlp_type, cfg.d_ff, seq), None


def _tf_block_forward(cfg: ModelConfig, p: PyTree, x, positions,
                      seq: bool = False):
    h = _norm(cfg, x, p["ln1"], seq)
    if cfg.mla:
        x = x + mla_mod.mla_full(cfg, p["mla"], h, positions, seq=seq)
    else:
        x = x + attn.attention_full(cfg, p["attn"], h, positions, seq=seq)
    return _ffn_half(cfg, p, x, seq)


def _tf_block_prefill(cfg: ModelConfig, p: PyTree, x, positions,
                      flash: bool = False, seq: bool = False):
    """Returns (x, entry) where entry holds this layer's full-sequence KV
    (GQA: ``k``/``v``; MLA: the latents ``ckv``/``krope``), scattered to
    the ring at model level."""
    h = _norm(cfg, x, p["ln1"], seq)
    if cfg.mla:
        a, (c_kv, k_rope) = mla_mod.mla_full(cfg, p["mla"], h, positions,
                                             seq=seq, latents=True)
        x = x + a
        entry = {"ckv": c_kv, "krope": k_rope}
    else:
        a, k, v = attn.attention_prefill(cfg, p["attn"], h, positions,
                                         flash, seq)
        x = x + a
        entry = {"k": k, "v": v}
    return _ffn_half(cfg, p, x, seq)[0], entry


def _tf_block_decode(cfg: ModelConfig, p: PyTree, x, cache, pos):
    h = norm(x, p["ln1"], cfg.norm_type, cfg.norm_eps)
    if cfg.mla:
        a, cache = mla_mod.mla_decode(cfg, p["mla"], h, cache, pos)
    else:
        a, cache = attn.attention_decode(cfg, p["attn"], h, cache, pos)
    return _ffn_half(cfg, p, x + a)[0], cache


def _mamba_block_forward(cfg: ModelConfig, p: PyTree, x, seq: bool = False):
    h = _norm(cfg, x, p["ln1"], seq)
    return x + ssm_mod.ssm_forward(cfg, p["ssm"], h, seq)


def _mamba_block_prefill(cfg: ModelConfig, p: PyTree, x, seq: bool = False):
    h = _norm(cfg, x, p["ln1"], seq)
    y, state, conv_tail = ssm_mod.ssm_prefill(cfg, p["ssm"], h, seq)
    return x + y, {"state": state, "conv": conv_tail}


def _mamba_block_decode(cfg: ModelConfig, p: PyTree, x, cache):
    h = norm(x, p["ln1"], cfg.norm_type, cfg.norm_eps)
    y, cache = ssm_mod.ssm_decode(cfg, p["ssm"], h, cache)
    return x + y, cache


def _stack_entries(entries) -> PyTree:
    """A list of per-layer cache entries -> one dict of stacked leaves."""
    return {name: torch.stack([e[name] for e in entries])
            for name in entries[0]}


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------

def stack_forward(cfg: ModelConfig, params: PyTree, x: torch.Tensor,
                  positions: torch.Tensor, seq: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """With ``cfg.remat`` each stacked layer's body (zamba2: each group's
    Mamba blocks and its shared block) is rematerialised (``remat``), as
    the reference checkpoints its scan bodies; the leading dense layers
    are not, as there.  ``seq``: ``x`` is the rank's rows of the sequence
    and so is the result (``positions`` stay the whole sequence's)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = params["layers"]

    def run(body, p, *xs):
        return remat(body, p, *xs) if cfg.remat else body(p, *xs)

    if cfg.family == "ssm":
        def mamba(p, h):
            return (_mamba_block_forward(cfg, p, h, seq),)

        for lp in _unstacked(layers):
            x, = run(mamba, lp, x)
        return x, aux

    if cfg.family == "hybrid":
        n_groups, every = hybrid_groups(cfg)
        per_layer = _unstacked(layers)

        def group(p, h, pos):
            for lp in p["mamba"]:
                h = _mamba_block_forward(cfg, lp, h, seq)
            return (_tf_block_forward(cfg, p["shared"], h, pos, seq)[0],)

        for g in range(n_groups):
            gp = {"mamba": per_layer[g * every:(g + 1) * every],
                  "shared": params["shared"]}
            x, = run(group, gp, x, positions)
        return x, aux

    # transformer families (dense / moe / audio / vlm); the aux loss sums
    # over the stacked layers, as the reference's scan carry does
    for dp in params.get("dense_layers", []):
        x, _ = _tf_block_forward(cfg, dp, x, positions, seq)

    def layer(p, h, pos):
        h, a = _tf_block_forward(cfg, p, h, pos, seq)
        return (h,) if a is None else (h, a)

    for lp in _unstacked(layers):
        out = run(layer, lp, x, positions)
        x = out[0]
        if len(out) > 1:
            aux = aux + out[1]
    return x, aux


def stack_prefill(cfg: ModelConfig, params: PyTree, x, positions,
                  flash: bool = False, seq: bool = False):
    """Returns (x, caches): ``caches["layers"]`` holds the stacked layers'
    entries (leaves (L, B, ...)); ``caches["shared"]`` zamba2's shared
    block's, one a group (leaves (n_groups, B, S, ...)); and
    ``caches["dense_layers"]`` a list of the leading dense layers'.
    ``flash``: GQA attention through the flash kernel.  ``seq``: ``x`` is
    the rank's rows of the sequence (and so is the result); the entries
    cover the whole sequence."""
    layers = params["layers"]
    if cfg.family in ("ssm", "hybrid"):
        n_groups, every = ((1, cfg.n_layers) if cfg.family == "ssm"
                           else hybrid_groups(cfg))
        m_entries, s_entries = [], []
        for g in range(n_groups):
            for i in range(g * every, (g + 1) * every):
                x, e = _mamba_block_prefill(cfg, _layer(layers, i), x, seq)
                m_entries.append(e)
            if cfg.family == "hybrid":
                x, e = _tf_block_prefill(cfg, params["shared"], x, positions,
                                         flash, seq)
                s_entries.append(e)
        caches = {"layers": _stack_entries(m_entries)}
        if s_entries:
            caches["shared"] = _stack_entries(s_entries)
        return x, caches

    caches: PyTree = {}
    dense = []
    for dp in params.get("dense_layers", []):
        x, e = _tf_block_prefill(cfg, dp, x, positions, flash, seq)
        dense.append(e)
    entries = []
    for i in range(cfg.n_layers - cfg.first_dense_layers):
        x, e = _tf_block_prefill(cfg, _layer(layers, i), x, positions,
                                 flash, seq)
        entries.append(e)
    caches["layers"] = _stack_entries(entries)
    if dense:
        caches["dense_layers"] = dense
    return x, caches


def stack_decode(cfg: ModelConfig, params: PyTree, caches: PyTree,
                 x: torch.Tensor, pos):
    """x (B,1,D); caches as produced by model.init_cache/prefill, updated
    in place (each layer's slice is a view of the stacked leaves)."""
    layers, lc = params["layers"], caches["layers"]
    if cfg.family in ("ssm", "hybrid"):
        n_groups, every = ((1, cfg.n_layers) if cfg.family == "ssm"
                           else hybrid_groups(cfg))
        for g in range(n_groups):
            for i in range(g * every, (g + 1) * every):
                x, _ = _mamba_block_decode(cfg, _layer(layers, i), x,
                                           _layer(lc, i))
            if cfg.family == "hybrid":
                x, _ = _tf_block_decode(cfg, params["shared"], x,
                                        _layer(caches["shared"], g), pos)
        return x, caches

    for dp, dc in zip(params.get("dense_layers", []),
                      caches.get("dense_layers", [])):
        x, _ = _tf_block_decode(cfg, dp, x, dc, pos)
    for i in range(cfg.n_layers - cfg.first_dense_layers):
        x, _ = _tf_block_decode(cfg, _layer(layers, i), x, _layer(lc, i),
                                pos)
    return x, caches
