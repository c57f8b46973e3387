"""Modality frontend stubs: the twin of ``repro/models/frontends.py``.

The ``[audio]`` (musicgen) and ``[vlm]`` (pixtral) architectures specify
the transformer backbone only; the EnCodec tokenizer and the Pixtral-ViT
vision tower are out of scope, so the forward reads precomputed frame or
patch embeddings.  :func:`synth_frontend_batch` makes matching synthetic
features through the threefry twin, so a key gives JAX's draws (the
targets bit for bit, the normals to ``erfinv``'s last bits).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch import prng


def frontend_feature_dim(cfg) -> int:
    return cfg.frontend_dim


def synth_frontend_batch(key: torch.Tensor, cfg, batch: int, seq_len: int
                         ) -> Dict[str, torch.Tensor]:
    """Synthetic embeddings ``[B, S, frontend_dim]`` float32 and targets
    ``[B, S]`` int32 from ``key`` (a key of the threefry twin)."""
    k1, k2 = prng.split(key)
    emb = prng.normal(k1, (batch, seq_len, cfg.frontend_dim))
    tgt = prng.randint(k2, (batch, seq_len), 0, cfg.vocab_size)
    return {"embeddings": emb, "targets": tgt}
