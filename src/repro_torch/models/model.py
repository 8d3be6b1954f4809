"""Unified model API over all architecture families (port of
``repro.models.model``): ``dense``, ``moe`` (phi3.5-moe; with MLA,
deepseek-v2), ``ssm`` (mamba2), ``hybrid`` (zamba2), ``audio`` and
``vlm``.

``Model`` holds no parameters: ``init`` builds the reference's parameter
tree (stacked layer leaves, the same keys) on the model's device from an
explicit ``torch.Generator``; ``forward``/``loss`` run full sequences
(scoring; with ``cfg.attn_impl == 'flash'`` GQA attention runs the
hand-written CUDA flash-attention kernel; MLA has no flash branch, as in
the reference), ``prefill`` + ``decode`` cached inference and
``generate`` greedy decoding.  The audio/VLM frontends are the
reference's stub: precomputed frame/patch embeddings enter through a
learned projector and occupy the first ``frontend_len`` positions.

A model runs on ``cuda`` unless built with ``device='cpu'``.  On the card
it sets the port's fp32 policy (``fl.engine.set_fp32_policy``): no TF32,
and bf16 matmuls reduce in fp32, as the reference accumulates them.
``loss`` returns the value, with ``router_aux_weight`` times the MoE aux
loss; its gradient (``torch.func.grad``, batched over clients by
``vmap`` in ``core.rounds``) is how the LMs train.  Training attends
with any ``attn_impl``: the flash kernels have a backward (the
reference's Pallas kernel has none), and ``chunked`` takes them on the
card in bf16.

Under a model group (``models.sharding.model_parallel``) the parameters
are a rank's tensor-parallel shards: the vocab dim of ``embed`` /
``lm_head`` is split where the group divides it, so the embedding is a
masked local lookup followed by ``reduce_from_model``, the head gives the
rank's vocab slice, and ``loss`` is a vocab-parallel cross entropy (the
row max, the sum of exps and the target's logit all-reduced in fp32; the
same value as the full-vocab one).  ``forward`` / ``prefill`` /
``decode`` return full-vocab logits on every rank.  MLA, SSD and hybrid
caches hold what the rank's layers read (the whole latent ring; its SSD
heads and conv channels; its kv heads).

With sequence parallelism on (``sharding.set_activation_sharding(
'model')``, a model group above 1) ``forward``, ``loss`` and ``prefill``
run the residual stream on the rank's rows of the sequence: the
embedding is cut to them (``sharding.split_seq``), the blocks keep them
(``blocks.stack_forward(seq=True)``), and the final norm's output is
gathered before the head (``sharding.enter``: ``gather_seq`` before the
vocab-parallel head).  A sequence the group does not divide raises
``ValueError``.  ``decode`` (one position) runs plain tensor parallelism.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.fl.engine import resolve_device, set_fp32_policy
from . import attention as attn_mod
from . import blocks
from . import mla as mla_mod
from . import sharding
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import lecun_normal, norm
from .remat import remat

PyTree = Any

__all__ = ["Model"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class Model:
    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_fp32_policy()

    # ------------------------------------------------------------------ init

    def init(self, gen: torch.Generator) -> PyTree:
        """Random parameters from ``gen``, a generator on the model's
        device (its numbers differ from ``jax.random``'s)."""
        cfg = self.cfg
        dt = _dtype_of(cfg)
        emb = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                          device=gen.device) * 0.02
        params: PyTree = {
            "embed": emb.to(dt),
            "decoder": blocks.stack_init(gen, cfg, dt),
            "final_norm": torch.ones((cfg.d_model,), dtype=dt,
                                     device=gen.device),
        }
        del emb
        if not cfg.tie_embeddings:
            params["lm_head"] = lecun_normal(gen, (cfg.d_model,
                                                   cfg.vocab_size), dt)
        if cfg.frontend:
            params["frontend_proj"] = lecun_normal(
                gen, (cfg.frontend_dim, cfg.d_model), dt)
        return params

    # --------------------------------------------------------------- forward

    def _embed(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings; from a vocab shard, the rows this rank holds
        (zeros elsewhere) summed over the model group."""
        emb = params["embed"]
        if not sharding.holds_shard(emb.shape[0], self.cfg.vocab_size):
            return emb[tokens.long()]
        local = tokens.long() - self._vocab_start(params)
        ok = (local >= 0) & (local < emb.shape[0])
        x = emb[local.clamp(0, emb.shape[0] - 1)]
        x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
        return sharding.reduce_from_model(x)

    def _vocab_start(self, params: PyTree) -> int:
        """The first vocab id of this rank's slice of the vocab dim."""
        return sharding.model_rank()[0] * params["embed"].shape[0]

    def _embed_inputs(self, params: PyTree, tokens: torch.Tensor,
                      prefix_emb: Optional[torch.Tensor]) -> torch.Tensor:
        x = self._embed(params, tokens)
        if self.cfg.frontend:
            if prefix_emb is None:
                raise ValueError(f"{self.cfg.name} requires prefix embeddings")
            pe = prefix_emb.to(x.dtype) @ params["frontend_proj"]
            x = torch.cat([pe, x], dim=1)
        return x

    def _head(self, params: PyTree) -> torch.Tensor:
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])

    def _vocab_split(self, params: PyTree) -> bool:
        return sharding.holds_shard(self._head(params).shape[-1],
                                    self.cfg.vocab_size)

    def _head_in(self, params: PyTree, x: torch.Tensor,
                 seq: bool = False) -> torch.Tensor:
        """The head's input over the whole sequence: through
        ``copy_to_model`` for a vocab shard; under ``seq`` gathered from
        the rank's rows (``sharding.enter``)."""
        return sharding.enter(x, self._vocab_split(params), seq)

    def _final_norm(self, params: PyTree, x: torch.Tensor, seq: bool):
        return norm(x, sharding.seq_weight(params["final_norm"], seq),
                    self.cfg.norm_type, self.cfg.norm_eps)

    def _logits(self, params: PyTree, x: torch.Tensor,
                seq: bool = False) -> torch.Tensor:
        """fp32 logits over this rank's vocab slice (all of it without a
        model group), for every position (``seq``: ``x`` the rank's
        rows)."""
        x = self._head_in(params, self._final_norm(params, x, seq), seq)
        return (x @ self._head(params)).float()

    def _stream_in(self, x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
        """The embedded sequence as the blocks take it: the rank's rows
        under sequence parallelism (``sharding.seq_parallel``)."""
        seq = sharding.seq_parallel(x.shape[1])
        return (sharding.split_seq(x) if seq else x), seq

    def _full_vocab(self, params: PyTree, logits: torch.Tensor
                    ) -> torch.Tensor:
        if not self._vocab_split(params):
            return logits
        _, m = sharding.model_rank()
        spec = (None,) * (logits.ndim - 1) + ("model",)
        return sharding.gather_shard(logits, spec, sharding.model_group(), m)

    def _forward(self, params: PyTree, tokens: torch.Tensor,
                 prefix_emb: Optional[torch.Tensor]):
        x = self._embed_inputs(params, tokens, prefix_emb)
        positions = torch.arange(x.shape[1], device=x.device)
        x, seq = self._stream_in(x)
        x, aux = blocks.stack_forward(self.cfg, params["decoder"], x,
                                      positions, seq)
        return self._logits(params, x, seq), aux

    def forward(self, params: PyTree, tokens: torch.Tensor,
                prefix_emb: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, K) [, prefix (B, P, fdim)] -> (logits (B, P+K, V), aux)."""
        logits, aux = self._forward(params, tokens, prefix_emb)
        return self._full_vocab(params, logits), aux

    def loss(self, params: PyTree, batch) -> torch.Tensor:
        """batch = (tokens, targets[, prefix_emb]); targets (B, K) aligned so
        targets[:, i] is the next token after tokens[:, i]."""
        tokens, targets = batch[0], batch[1]
        prefix = batch[2] if len(batch) > 2 else None
        cfg = self.cfg
        P = cfg.frontend_len if cfg.frontend else 0

        if self._vocab_split(params):
            start = self._vocab_start(params)

            def nll_of(logits, tgt):
                return _nll_vocab_parallel(logits, tgt, start)
        else:
            def nll_of(logits, tgt):
                lse = torch.logsumexp(logits, dim=-1)
                correct = logits.gather(-1, tgt.long()[..., None])[..., 0]
                return (lse - correct).sum()

        C = cfg.loss_chunk
        S = tokens.shape[1]
        if not (C and S % C == 0 and S > C):
            logits, aux = self._forward(params, tokens, prefix)
            nll = nll_of(logits[:, P:], targets) / targets.numel()
            return nll + cfg.router_aux_weight * aux

        # seq-chunked head+loss: the fp32 logits exist only (B, C, V) at a
        # time, never (B, S, V); with cfg.remat each chunk is recomputed
        # in the backward pass too, so no chunk's logits are kept for it
        x = self._embed_inputs(params, tokens, prefix)
        positions = torch.arange(x.shape[1], device=x.device)
        x, seq = self._stream_in(x)
        x, aux = blocks.stack_forward(cfg, params["decoder"], x, positions,
                                      seq)
        x = self._head_in(params, self._final_norm(params, x, seq),
                          seq)[:, P:]
        head = self._head(params)

        def chunk_nll(h, xc, tc):
            return (nll_of((xc @ h).float(), tc),)

        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i0 in range(0, S, C):
            args = (head, x[:, i0:i0 + C], targets[:, i0:i0 + C])
            nll, = (remat(chunk_nll, *args) if cfg.remat
                    else chunk_nll(*args))
            total = total + nll
        return total / targets.numel() + cfg.router_aux_weight * aux

    # ----------------------------------------------------------------- cache

    def init_cache(self, batch: int, max_len: int) -> PyTree:
        """Decode cache sized ``max_len`` (pass min(context, window))."""
        cfg, dt, dev = self.cfg, _dtype_of(self.cfg), self.device
        if cfg.family in ("ssm", "hybrid"):
            out = {"layers": ssm_mod.make_ssm_cache(cfg, batch, cfg.n_layers,
                                                    dt, dev)}
            if cfg.family == "hybrid":
                out["shared"] = attn_mod.make_kv_cache(
                    cfg, batch, max_len, blocks.hybrid_groups(cfg)[0], dt,
                    dev)
            return out
        maker = mla_mod.make_mla_cache if cfg.mla else attn_mod.make_kv_cache
        out = {"layers": maker(cfg, batch, max_len,
                               cfg.n_layers - cfg.first_dense_layers, dt,
                               dev)}
        if cfg.first_dense_layers:
            out["dense_layers"] = [
                tree_map(lambda a: a[0], maker(cfg, batch, max_len, 1, dt,
                                               dev))
                for _ in range(cfg.first_dense_layers)]
        return out

    def _scatter_ring(self, full: torch.Tensor, W: int, axis_seq: int = 2
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """full (..., S, ...) per-position values -> ring buffer (..., W, ...)
        plus kpos (W,).  Keeps the last min(S, W) positions, position
        ``pos`` in slot ``pos % W``.

        Two layouts: with S <= W the positions sit in slots 0..S-1
        (identity, zero-padded to W); with S > W the last W positions
        are a roll of the tail.  (The reference's third, scatter branch
        needs fewer than W kept positions that do not start at a
        multiple of W; fewer than W kept means S < W, which starts at 0,
        so it is never taken.)"""
        S = full.shape[axis_seq]
        keep = min(S, W)
        start = S - keep
        tail = full.narrow(axis_seq, start, keep)
        pos = torch.arange(start, S, dtype=torch.int32, device=full.device)
        if start % W == 0:
            if keep == W:
                return tail, pos
            pad = list(full.shape)
            pad[axis_seq] = W - keep
            buf = torch.cat([tail, full.new_zeros(pad)], dim=axis_seq)
            kpos = torch.cat([pos, pos.new_full((W - keep,), -1)])
            return buf, kpos
        shift = start % W
        return (torch.roll(tail, shift, dims=axis_seq),
                torch.roll(pos, shift))

    def prefill(self, params: PyTree, tokens: torch.Tensor,
                prefix_emb: Optional[torch.Tensor] = None,
                max_len: Optional[int] = None, flash: bool = False
                ) -> Tuple[torch.Tensor, PyTree]:
        """Run the prompt, build the decode cache.

        Returns (last-position logits (B, V), cache).  ``max_len`` sets the
        ring size (>= prompt length for exact full-context decode; window
        size for sliding-window archs).  The layers attend with the plain
        path, as the reference's prefill does, or with the flash kernel
        (``flash``, GQA only)."""
        cfg = self.cfg
        x = self._embed_inputs(params, tokens, prefix_emb)
        S = x.shape[1]
        if max_len is None:
            max_len = S if cfg.sliding_window is None else cfg.sliding_window
        positions = torch.arange(S, device=x.device)
        x, seq = self._stream_in(x)
        x, entries = blocks.stack_prefill(cfg, params["decoder"], x,
                                          positions, flash, seq)
        # the whole sequence back on every rank, as replicated compute
        x = sharding.enter(x, False, seq)
        logits = self._full_vocab(params,
                                  self._logits(params, x[:, -1:])[:, 0])

        def ring(e):
            """Full-sequence entries, leaves (L, B, S, ...) -> ring
            buffers (L, B, W, ...) and a real (L, W) ``kpos``, whose rows
            decode writes in place."""
            out = {}
            for name, full in e.items():
                out[name], kpos = self._scatter_ring(full, max_len,
                                                     axis_seq=2)
                L = full.shape[0]
            out["kpos"] = kpos.expand(L, max_len).contiguous()
            return out

        if cfg.family in ("ssm", "hybrid"):
            cache = {"layers": entries["layers"]}       # state, conv tail
            if cfg.family == "hybrid":
                cache["shared"] = ring(entries["shared"])
            return logits, cache
        cache = {"layers": ring(entries["layers"])}
        if "dense_layers" in entries:
            cache["dense_layers"] = [
                tree_map(lambda a: a[0],
                         ring(tree_map(lambda a: a[None], e)))
                for e in entries["dense_layers"]]
        return logits, cache

    # ---------------------------------------------------------------- decode

    def decode(self, params: PyTree, cache: PyTree, token: torch.Tensor,
               pos) -> Tuple[torch.Tensor, PyTree]:
        """One step: token (B,) ints, pos the absolute position of this
        token (int or 0-d tensor).  Returns (logits (B, V), the cache,
        updated in place)."""
        x = self._embed(params, token.long()[:, None])
        x, cache = blocks.stack_decode(self.cfg, params["decoder"], cache, x,
                                       pos)
        return self._full_vocab(params, self._logits(params, x)[:, 0]), cache

    # ------------------------------------------------------------- utilities

    def generate(self, params: PyTree, tokens: torch.Tensor, n_new: int,
                 prefix_emb: Optional[torch.Tensor] = None,
                 max_len: Optional[int] = None) -> torch.Tensor:
        """Greedy generation (host loop): (B, n_new) int64 tokens."""
        cfg = self.cfg
        K = tokens.shape[1]
        P = cfg.frontend_len if cfg.frontend else 0
        prompt_len = K + P
        if max_len is None:
            win = cfg.sliding_window
            max_len = prompt_len + n_new if win is None else win
        logits, cache = self.prefill(params, tokens, prefix_emb, max_len)
        out = [torch.argmax(logits, -1)]
        for i in range(n_new - 1):
            logits, cache = self.decode(params, cache, out[-1],
                                        prompt_len + i)
            out.append(torch.argmax(logits, -1))
        return torch.stack(out, dim=1)

    def param_count(self, params: PyTree) -> int:
        return int(sum(p.numel() for p in tree_leaves(params)))


def _nll_vocab_parallel(logits: torch.Tensor, tgt: torch.Tensor,
                        start: int) -> torch.Tensor:
    """The summed cross entropy of fp32 ``logits`` over this rank's vocab
    slice ``[start, start + V_local)``: the row max, the sum of exps and
    the target's logit (zero on the ranks that do not hold it) reduced
    over the model group."""
    V = logits.shape[-1]
    mx = sharding.all_reduce_max(logits.amax(-1))
    sum_exp = sharding.reduce_from_model(
        torch.exp(logits - mx[..., None]).sum(-1))
    local = tgt.long() - start
    ok = (local >= 0) & (local < V)
    picked = logits.gather(-1, local.clamp(0, V - 1)[..., None])[..., 0]
    correct = sharding.reduce_from_model(
        torch.where(ok, picked, torch.zeros_like(picked)))
    return (torch.log(sum_exp) + mx - correct).sum()
