"""Model architecture config: a copy of ``repro.configs.base.ModelConfig``.

The port keeps its own copy (it imports nothing of ``repro``); field names
and defaults are the reference's, so a reference config converts with
``ModelConfig(**dataclasses.asdict(cfg))``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description for the generic LM stack.

    ``block_pattern`` is cycled over the depth: each entry names the token
    mixer of one layer.  The pattern period is the unit of the stacked
    ``periods`` parameter layout: ``num_layers // len(pattern)`` periods,
    with the remainder held per layer.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- token mixer pattern ---
    block_pattern: Tuple[str, ...] = ("attn",)
    window_size: int = 1024  # for "local" mixers
    qkv_bias: bool = False
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0

    # --- MoE ---
    num_experts: int = 0
    moe_top_k: int = 0
    moe_dense_ff: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state_dim: int = 0
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_chunk: int = 256

    # --- hybrid (RecurrentGemma RG-LRU) ---
    rglru_width: int = 0
    rglru_conv_width: int = 4

    # --- misc architecture ---
    rope_theta: float = 10000.0
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu | gelu
    gated_mlp: bool = True
    tie_embeddings: bool = False

    # --- the paper's technique (spiking mode) ---
    spiking: bool = False
    spike_T: int = 4
    attention_kind: str = "softmax"  # softmax | ssa | lif

    # --- modality frontend stub ---
    frontend: str = "none"
    frontend_dim: int = 0

    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.period

    @property
    def remainder_layers(self) -> int:
        return self.num_layers % self.period

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def validate(self) -> "ModelConfig":
        if self.d_model <= 0 or self.num_layers <= 0:
            raise ValueError(f"{self.name}: d_model and num_layers must be > 0")
        if self.num_heads and self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(
                f"{self.name}: heads {self.num_heads} not a multiple of kv "
                f"heads {self.num_kv_heads}")
        return self


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The fields of ``repro.configs.base.ParallelConfig`` that the train
    step reads (:mod:`repro_torch.train.loop`), with the reference's
    meanings on a ``(data, model)`` mesh: ``fsdp`` cuts the experts'
    ``d_ff`` over ``data`` (the reference's ZeRO-3 cut of the ``embed``
    axis is not ported: those leaves stay whole), ``seq_shard`` splits a
    MoE block's tokens over ``model`` by sequence, and ``pure_dp`` holds
    every leaf whole and splits the batch over ``data x model``."""

    fsdp: bool = True  # experts' d_ff over "data"
    seq_shard: bool = True  # MoE tokens over "model" by sequence
    pure_dp: bool = False  # every leaf whole, the batch over every rank
    remat: str = "block"  # none | block | full
    grad_compression: bool = False  # int8 error-feedback round trip
    grad_dtype: str = "native"  # native | bfloat16 (cast before the update)
    microbatches: int = 1  # gradient accumulation steps
    moe_impl: str = "ep_a2a"  # ep_a2a | dense
