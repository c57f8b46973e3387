"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global, 128k  [hf:google/gemma-3-1b-pt; unverified].

Pattern: five sliding-window (1024) layers followed by one global layer,
cycled over the 62-layer depth (10 full periods + 2 remainder local layers).
``sub_quadratic`` is False (the global layers keep a full KV cache), but the
5:1 interleave makes decode near-linear; per the assignment note gemma3 runs
``long_500k`` (see DESIGN.md skip list)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    block_pattern=("local", "local", "local", "local", "local", "attn"),
    window_size=1024,
    norm_type="rmsnorm",
    act="gelu",
    gated_mlp=True,
    tie_embeddings=True,
).validate()
