"""Unified model configuration covering all assigned architecture families.

One dataclass describes dense GQA transformers, MLA (DeepSeek), MoE,
Mamba2/SSD, Zamba2-style hybrids, and the audio/VLM decoder backbones.
Reduced "smoke" variants (2 layers, d_model <= 512, <= 4 experts) are
produced by ``ModelConfig.reduced()`` for CPU tests.  A copy of
``repro.models.config`` (pure Python, kept whole so that the port never
imports the reference); the port's model stack runs every family, at
full width on the GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                   # 0 for attention-free (ssm)
    n_kv_heads: int
    d_ff: int                      # dense-MLP hidden dim (0 for pure ssm)
    vocab_size: int

    # --- attention ---------------------------------------------------------
    head_dim: Optional[int] = None          # default d_model // n_heads
    qk_norm: bool = False                   # qwen3
    qkv_bias: bool = False                  # qwen1.5 / qwen2 / internvl2
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0              # stablelm-2 uses 0.25
    norm_type: str = "rms"                  # 'rms' | 'layer'
    mlp_type: str = "swiglu"                # 'swiglu' | 'gelu'
    sliding_window: Optional[int] = None    # static window; long-context decode

    # --- MLA (deepseek-v2) --------------------------------------------------
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0                    # 0 => full-rank q projection
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                       # per-expert ffn dim
    first_dense_layers: int = 0             # deepseek: layer 0 is dense
    moe_impl: str = "ragged"                # 'ragged' | 'dense' (oracle)
    moe_chunk: int = 0                      # token-chunked dispatch (0 = off)
    router_aux_weight: float = 0.01

    # --- SSM (mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 64
    ssm_groups: int = 1

    # --- hybrid (zamba2) ------------------------------------------------------
    hybrid_attn_every: int = 6              # shared attn block period

    # --- modality frontend (stubbed per assignment) --------------------------
    frontend: Optional[str] = None          # 'audio' | 'vision'
    frontend_dim: int = 0                   # provided-embedding dim
    frontend_len: int = 0                   # prefix positions in the sequence

    # --- misc -----------------------------------------------------------------
    norm_eps: float = 1e-6
    dtype: str = "float32"                  # params/activations dtype
    tie_embeddings: bool = False
    remat: bool = True                      # activation checkpoint per layer
    # 'ref' | 'chunked' | 'flash' (CUDA kernels).  'chunked' runs the flash
    # kernels too where its input is bf16 on the card at a head dim up to
    # 128 (models/attention.py::_kernel_route), so on the card in bf16 the
    # two name one path
    attn_impl: str = "ref"
    # query-chunk size of 'chunked''s plain route (the CPU, fp32, head dims
    # over 128) and of MLA's chunked path; the kernel route has no chunks
    attn_chunk: int = 512
    loss_chunk: int = 0                     # seq-chunked lm head+loss (0 = off)
    moe_sharding: str = "tensor"            # 'tensor' | 'expert' (all_to_all)

    # ---------------------------------------------------------------------

    def __post_init__(self):
        if self.family not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm"):
            raise ValueError(f"unknown family {self.family}")
        if self.family != "ssm" and self.n_heads:
            hd = self.head_dim or self.d_model // self.n_heads
            if self.n_heads % max(self.n_kv_heads, 1):
                raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.family == "moe" and not self.n_experts:
            raise ValueError("moe family needs n_experts")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def uses_attention(self) -> bool:
        return self.family in ("dense", "moe", "audio", "vlm", "hybrid")

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                vocab: int = 512, seq_friendly: bool = True) -> "ModelConfig":
        """Smoke-test variant of the same family (per assignment:
        <= 2 layers, d_model <= 512, <= 4 experts)."""
        hd = 32
        n_heads = max(d_model // 64, 2)
        # preserve the GQA group ratio of the full config
        ratio = max(self.n_heads // max(self.n_kv_heads, 1), 1)
        n_kv = max(1, n_heads // ratio)
        while n_heads % n_kv:
            n_kv -= 1
        changes = dict(
            n_layers=n_layers,
            d_model=d_model,
            n_heads=(n_heads if self.n_heads else 0),
            n_kv_heads=(n_kv if self.n_heads else 0),
            head_dim=(hd if self.n_heads else None),
            d_ff=(d_model * 3 if self.d_ff else 0),
            vocab_size=vocab,
            dtype="float32",
            remat=False,
        )
        if self.mla:
            changes.update(kv_lora_rank=64, q_lora_rank=0, rope_head_dim=16,
                           nope_head_dim=32, v_head_dim=32)
        if self.n_experts:
            changes.update(n_experts=4, experts_per_token=2,
                           n_shared_experts=min(self.n_shared_experts, 1),
                           moe_d_ff=d_model * 2,
                           first_dense_layers=min(self.first_dense_layers, 1),
                           moe_impl="dense")  # vmap/grad-safe oracle on CPU
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.family == "hybrid":
            changes.update(hybrid_attn_every=1)
        if self.frontend:
            changes.update(frontend_dim=48, frontend_len=8)
        if self.sliding_window:
            changes.update(sliding_window=64)
        return dataclasses.replace(self, name=self.name + "-smoke", **changes)

    # --- parameter counting (for roofline MODEL_FLOPS = 6*N*D) -------------

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count; ``active_only`` counts routed experts
        only at experts_per_token (MoE roofline convention)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d

        def attn_params() -> int:
            if self.mla:
                q = (d * self.q_lora_rank
                     + self.q_lora_rank * n_q * (self.nope_head_dim
                                                 + self.rope_head_dim)
                     ) if self.q_lora_rank else d * n_q * (
                         self.nope_head_dim + self.rope_head_dim)
                kv = d * (self.kv_lora_rank + self.rope_head_dim)
                kv += self.kv_lora_rank * n_q * (self.nope_head_dim
                                                 + self.v_head_dim)
                o = n_q * self.v_head_dim * d
                return q + kv + o
            qkv = d * (n_q + 2 * n_kv) * hd
            if self.qkv_bias:
                qkv += (n_q + 2 * n_kv) * hd
            return qkv + n_q * hd * d

        def mlp_params(ff: int) -> int:
            if self.mlp_type == "swiglu":
                return 3 * d * ff
            return 2 * d * ff

        def moe_layer() -> int:
            routed = self.n_experts if not active_only else self.experts_per_token
            p = routed * 3 * d * self.moe_d_ff
            p += self.n_shared_experts * 3 * d * self.moe_d_ff
            p += d * self.n_experts  # router
            return p

        def mamba_params() -> int:
            di, g, n, h = (self.d_inner, self.ssm_groups, self.ssm_state,
                           self.ssm_heads)
            p = d * di * 2                       # x and z projections
            p += d * (2 * g * n)                 # B, C projections
            p += d * h                           # dt projection
            p += self.ssm_conv_width * (di + 2 * g * n)  # depthwise conv
            p += h * 2                           # A_log, D
            p += di                              # gated norm
            p += di * d                          # out projection
            return p

        per_layer_norms = 2 * d
        total = emb + head + d  # final norm
        if self.family == "ssm":
            total += self.n_layers * (mamba_params() + d)
        elif self.family == "hybrid":
            total += self.n_layers * (mamba_params() + d)
            n_shared = max(self.n_layers // self.hybrid_attn_every, 1)
            total += attn_params() + mlp_params(self.d_ff) + per_layer_norms
        else:
            moe_layers = (self.n_layers - self.first_dense_layers
                          if self.n_experts else 0)
            dense_layers = self.n_layers - moe_layers
            total += dense_layers * (attn_params() + mlp_params(self.d_ff)
                                     + per_layer_norms)
            if moe_layers:
                total += moe_layers * (attn_params() + moe_layer()
                                       + per_layer_norms)
        if self.frontend:
            total += self.frontend_dim * d
        return int(total)
