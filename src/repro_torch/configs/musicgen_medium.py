"""musicgen-medium [audio] — 48L d_model=1536 24H (GQA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens  [arXiv:2306.05284; hf].

The EnCodec frontend is a STUB: ``input_specs()`` provides precomputed
frame embeddings (dim 128, EnCodec latent width)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    norm_type="layernorm",
    act="gelu",
    gated_mlp=False,
    frontend="audio_frames",
    frontend_dim=128,
).validate()
