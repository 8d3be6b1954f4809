"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048
-- decoder-only over EnCodec tokens.  [arXiv:2306.05284]

The EnCodec conv codec frontend is STUBBED per assignment: ``input_specs``
provides precomputed frame embeddings (frontend_dim) consumed through a
learned projector.  Deviation noted in DESIGN.md: rotary positions instead
of MusicGen's sinusoidal embeddings (positional scheme is orthogonal to the
paper's contribution)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        mlp_type="gelu",
        frontend="audio",
        frontend_dim=128,      # EnCodec latent dim stand-in
        frontend_len=256,      # conditioning frames
        dtype="bfloat16",
    )
