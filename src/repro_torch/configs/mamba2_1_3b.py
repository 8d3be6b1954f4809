"""mamba2-1.3b [ssm]: 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128 -- SSD (state-space duality).  [arXiv:2405.21060]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv_width=4,
        ssm_chunk=128,
        dtype="bfloat16",
    )
