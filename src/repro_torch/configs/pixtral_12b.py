"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT + mistral-nemo  [hf:mistralai/Pixtral-12B-2409;
unverified].

The Pixtral-ViT vision tower is a STUB: ``input_specs()`` provides
precomputed patch embeddings (dim 1024, the ViT hidden width)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,  # mistral-nemo style: 32 heads x 128 != d_model
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1000000.0,
    norm_type="rmsnorm",
    act="silu",
    gated_mlp=True,
    frontend="vision_patches",
    frontend_dim=1024,
).validate()
