"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 -- qk_norm, GQA, head_dim=128.  [hf:Qwen/Qwen3-8B family]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=25600,
        vocab_size=151936,
        qk_norm=True,
        qkv_bias=False,
        rope_theta=1e6,
        mlp_type="swiglu",
        dtype="bfloat16",
    )
