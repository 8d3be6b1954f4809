"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 -- InternViT + InternLM2/Qwen2-0.5B backbone.  [arXiv:2404.16821]

The InternViT vision tower is STUBBED per assignment: ``input_specs``
provides precomputed patch embeddings (frontend_dim=1024, the ViT output
width) consumed through the learned projector."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab_size=151655,
        qkv_bias=True,
        rope_theta=1e6,
        frontend="vision",
        frontend_dim=1024,
        frontend_len=256,      # image patch tokens
        dtype="bfloat16",
    )
