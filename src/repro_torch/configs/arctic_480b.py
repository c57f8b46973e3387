"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + dense residual  [hf:Snowflake/snowflake-arctic-base; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    moe_top_k=2,
    moe_dense_ff=4864,  # arctic's dense residual MLP path
    norm_type="rmsnorm",
    act="silu",
    gated_mlp=True,
).validate()
