"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536(per-expert)
vocab=102400, MoE 160 routed experts top-6 + 2 shared -- MLA kv_lora=512,
q_lora=1536, first layer dense (d_ff=12288).  [arXiv:2405.04434]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=12288,             # dense (first) layer ffn
        vocab_size=102400,
        mla=True,
        kv_lora_rank=512,
        q_lora_rank=1536,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
        n_experts=160,
        experts_per_token=6,
        n_shared_experts=2,
        moe_d_ff=1536,
        first_dense_layers=1,
        rope_theta=1e4,
        dtype="bfloat16",
    )
