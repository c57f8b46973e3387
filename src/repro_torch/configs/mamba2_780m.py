"""mamba2-780m [ssm] — 48L d_model=1536 (attn-free) d_ff=0 vocab=50280,
ssm_state=128 — SSD (state-space duality)  [arXiv:2405.21060; unverified]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,  # attention-free, no FFN: the SSD block is the whole layer
    vocab_size=50280,
    block_pattern=("ssd",),
    ssm_state_dim=128,
    ssm_conv_width=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_n_groups=1,
    norm_type="rmsnorm",
    tie_embeddings=True,
).validate()
