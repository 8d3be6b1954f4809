"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64 -- Mamba2 backbone + shared attention block
applied every 6 layers.  [arXiv:2411.15242]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab_size=32000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv_width=4,
        ssm_chunk=128,
        hybrid_attn_every=6,
        dtype="bfloat16",
    )
