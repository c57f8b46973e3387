"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

Twin of ``repro.configs.registry``: the ten public architectures and the
paper's two spiking GPT decoders on the generic LM stack (every name
serves, forwards and trains on one device and on a ``(data, model)``
mesh).
``reduced_config`` is the reference's CPU smoke reduction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import (
    arctic_480b,
    gemma3_27b,
    granite_3_8b,
    mamba2_780m,
    musicgen_medium,
    phi35_moe_42b,
    pixtral_12b,
    qwen25_32b,
    recurrentgemma_9b,
    xpikeformer,
    yi_9b,
)
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        arctic_480b.CONFIG,
        phi35_moe_42b.CONFIG,
        mamba2_780m.CONFIG,
        musicgen_medium.CONFIG,
        pixtral_12b.CONFIG,
        qwen25_32b.CONFIG,
        yi_9b.CONFIG,
        gemma3_27b.CONFIG,
        granite_3_8b.CONFIG,
        recurrentgemma_9b.CONFIG,
        xpikeformer.GPT_4_256,
        xpikeformer.GPT_8_512,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> List[str]:
    return list(ARCHS)


def reduced_config(name: str) -> ModelConfig:
    """Same-family reduced config for CPU smoke tests: small depth and
    width, few experts, tiny vocab; two periods plus one remainder layer
    when the full config has a remainder."""
    cfg = get_config(name)
    period = cfg.period
    layers = 2 * period + (1 if cfg.remainder_layers else 0)
    heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    kv = max(1, heads * cfg.num_kv_heads // max(cfg.num_heads, 1)) if heads else 0
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16 if heads else 0,
        d_ff=0 if cfg.d_ff == 0 else 128,
        moe_dense_ff=0 if cfg.moe_dense_ff == 0 else 128,
        vocab_size=257,
        num_experts=0 if cfg.num_experts == 0 else 4,
        moe_top_k=0 if cfg.moe_top_k == 0 else 2,
        window_size=min(cfg.window_size, 8),
        ssm_state_dim=0 if cfg.ssm_state_dim == 0 else 16,
        ssm_head_dim=16,
        rglru_width=0 if cfg.rglru_width == 0 else 32,
        frontend_dim=0 if cfg.frontend == "none" else 24,
        dtype="float32",
    ).validate()
