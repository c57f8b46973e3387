"""Architecture registry of the port: the spiking GPT decoders only.

``reduced_config`` is the reference's CPU smoke reduction
(``repro.configs.registry.reduced_config``) for these names: 2 layers,
``d=64``, 4 heads of width 16, ``d_ff=128``, vocab 257, float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import xpikeformer
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (xpikeformer.GPT_4_256, xpikeformer.GPT_8_512)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> List[str]:
    return list(ARCHS)


def reduced_config(name: str) -> ModelConfig:
    """Same-family reduced config for CPU tests (the reference's rules,
    restricted to the fields a spiking GPT uses)."""
    cfg = get_config(name)
    layers = 2 * cfg.period + (1 if cfg.remainder_layers else 0)
    heads = min(cfg.num_heads, 4)
    kv = max(1, heads * cfg.num_kv_heads // cfg.num_heads)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=257,
        window_size=min(cfg.window_size, 8),
        ssm_head_dim=16,
        dtype="float32",
    ).validate()
