"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attn, 1:2  [arXiv:2402.19427; unverified].

Pattern: (rglru, rglru, local-attention) cycled — 12 full periods + 2
remainder RG-LRU layers.  Fully sub-quadratic (the only attention is a
2048-token sliding window), so it runs ``long_500k``."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"),
    window_size=2048,
    rglru_width=4096,
    rglru_conv_width=4,
    norm_type="rmsnorm",
    act="gelu",
    gated_mlp=True,
    tie_embeddings=True,
).validate()
