"""Decoder blocks and layer stacks (port of ``repro.models.blocks``) for
the transformer families the port runs: ``dense``, ``audio`` and ``vlm``.

Layer parameters are *stacked* (a leading ``n_layers`` axis on every
leaf, the reference's tree), so parameter trees carry across from the
JAX package unchanged (``models.convert.params_from_numpy``).  The
reference's ``jax.lax.scan`` over layers is a Python loop over views of
the stacked leaves; ``remat`` has no meaning without a backward pass.
MoE, MLA, ``ssm`` and ``hybrid`` configs raise ``NotImplementedError``.

Three entry points serve ``model.py``:
  * ``stack_forward``  -- full-sequence scoring, returns aux loss (0)
  * ``stack_prefill``  -- forward + per-layer KV entries (stacked)
  * ``stack_decode``   -- one-token step through the per-layer caches

As in the reference, prefill attends with the plain ``_sdpa`` whatever
``cfg.attn_impl`` is; only ``stack_forward`` reaches the flash kernel.
The reference's sequence-parallel hooks (``models/sharding.py``) are the
identity on one device and are not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.core.pytree import tree_flatten, tree_map, tree_unflatten
from . import attention as attn
from .config import ModelConfig
from .layers import mlp_apply, mlp_init, norm

PyTree = Any

__all__ = ["stack_init", "stack_forward", "stack_prefill", "stack_decode",
           "transformer_block_init", "check_supported", "FAMILIES"]

FAMILIES = ("dense", "audio", "vlm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the families the port does not run yet."""
    if cfg.family not in FAMILIES or cfg.mla or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: the port's model stack runs the {FAMILIES} "
            f"transformer families without experts or MLA; "
            f"{cfg.family!r}{' with MLA' if cfg.mla else ''} is not ported "
            "yet (ROADMAP queue 1 item 12)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def transformer_block_init(gen: torch.Generator, cfg: ModelConfig,
                           dtype) -> PyTree:
    ones = torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)
    return {"ln1": ones, "ln2": ones.clone(),
            "attn": attn.attn_init(gen, cfg, dtype),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype)}


def _stacked(n: int, make: Callable[[], PyTree]) -> PyTree:
    """``n`` draws of ``make()`` stacked leaf-wise along a new leading
    axis, written into the stacked leaves one layer at a time (no second
    copy of the whole stack)."""
    leaves, treedef = tree_flatten(make())
    out = [torch.empty((n,) + tuple(a.shape), dtype=a.dtype, device=a.device)
           for a in leaves]
    for i in range(n):
        if i:
            leaves = tree_flatten(make())[0]
        for o, a in zip(out, leaves):
            o[i] = a
    return tree_unflatten(treedef, out)


def stack_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> PyTree:
    """All decoder-layer parameters (embed/head live in model.py)."""
    check_supported(cfg)
    return {"layers": _stacked(
        cfg.n_layers, lambda: transformer_block_init(gen, cfg, dtype))}


def _layer(tree: PyTree, i: int) -> PyTree:
    return tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# Per-layer forward / prefill / decode
# ---------------------------------------------------------------------------

def _mlp_half(cfg: ModelConfig, p: PyTree, x: torch.Tensor) -> torch.Tensor:
    h = norm(x, p["ln2"], cfg.norm_type, cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.mlp_type)


def _tf_block_forward(cfg: ModelConfig, p: PyTree, x, positions):
    h = norm(x, p["ln1"], cfg.norm_type, cfg.norm_eps)
    x = x + attn.attention_full(cfg, p["attn"], h, positions)
    return _mlp_half(cfg, p, x)


def _tf_block_prefill(cfg: ModelConfig, p: PyTree, x, positions):
    """Returns (x, entry) where entry holds this layer's full-sequence KV
    (scattered to the ring at model level)."""
    h = norm(x, p["ln1"], cfg.norm_type, cfg.norm_eps)
    q, k, v = attn._project_qkv(cfg, p["attn"], h, positions)
    mask = attn._causal_mask(h.shape[1], cfg.sliding_window, h.device)
    x = x + attn._sdpa(q, k, v, mask, cfg) @ p["attn"]["o"]["w"]
    return _mlp_half(cfg, p, x), {"k": k, "v": v}


def _tf_block_decode(cfg: ModelConfig, p: PyTree, x, cache, pos):
    h = norm(x, p["ln1"], cfg.norm_type, cfg.norm_eps)
    a, cache = attn.attention_decode(cfg, p["attn"], h, cache, pos)
    return _mlp_half(cfg, p, x + a), cache


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------

def stack_forward(cfg: ModelConfig, params: PyTree, x: torch.Tensor,
                  positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    check_supported(cfg)
    for i in range(cfg.n_layers):
        x = _tf_block_forward(cfg, _layer(params["layers"], i), x, positions)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def stack_prefill(cfg: ModelConfig, params: PyTree, x, positions):
    """Returns (x, caches): ``caches["layers"]`` holds ``k``/``v`` of
    shape (n_layers, B, S, Hkv, hd)."""
    check_supported(cfg)
    entries = []
    for i in range(cfg.n_layers):
        x, e = _tf_block_prefill(cfg, _layer(params["layers"], i), x,
                                 positions)
        entries.append(e)
    return x, {"layers": {name: torch.stack([e[name] for e in entries])
                          for name in ("k", "v")}}


def stack_decode(cfg: ModelConfig, params: PyTree, caches: PyTree,
                 x: torch.Tensor, pos):
    """x (B,1,D); caches as produced by model.init_cache/prefill, updated
    in place (each layer's slice is a view of the stacked leaves)."""
    check_supported(cfg)
    for i in range(cfg.n_layers):
        x, _ = _tf_block_decode(cfg, _layer(params["layers"], i), x,
                                _layer(caches["layers"], i), pos)
    return x, caches
