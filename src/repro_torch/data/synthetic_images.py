"""Procedural image-classification data: ``repro.data.synthetic_images``.

10 classes of oriented sinusoidal gratings with per-sample random phase,
amplitude jitter, colour cast and additive noise, in ``[0, 1]``.  The
draws come from an explicit ``torch.Generator`` with the reference's
distributions; images are data, not spikes, so they need not equal the
reference's bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Union

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ImageConfig:
    size: int = 32
    channels: int = 3
    num_classes: int = 10
    noise: float = 0.35


def generator(seed_or_gen: Union[int, torch.Generator]) -> torch.Generator:
    """A CPU generator: ``seed_or_gen`` itself, or a new one seeded by it."""
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    return torch.Generator().manual_seed(int(seed_or_gen))


def _class_params(num_classes: int):
    angles = torch.linspace(0.0, math.pi * 0.9, num_classes)
    freqs = 2.0 + 3.0 * (torch.arange(num_classes) % 3).to(torch.float32)
    return angles, freqs


def sample_batch(seed_or_gen: Union[int, torch.Generator], cfg: ImageConfig,
                 batch: int, device: Union[str, torch.device] = "cpu"
                 ) -> Dict[str, Tensor]:
    """``{"images": [B, size, size, channels] f32, "labels": [B] int64}``,
    drawn on the CPU and moved to ``device``."""
    gen = generator(seed_or_gen)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen)
    angles, freqs = _class_params(cfg.num_classes)
    a, f = angles[labels], freqs[labels]
    phase = torch.rand(batch, generator=gen) * 2 * math.pi
    amp = 0.7 + 0.3 * torch.rand(batch, generator=gen)

    xs = torch.linspace(0, 1, cfg.size)
    gx, gy = torch.meshgrid(xs, xs, indexing="ij")
    arg = (2 * math.pi * f[:, None, None]
           * (gx[None] * torch.cos(a)[:, None, None]
              + gy[None] * torch.sin(a)[:, None, None])
           + phase[:, None, None])
    base = amp[:, None, None] * torch.sin(arg)  # [B,H,W]
    col = 0.5 + 0.5 * torch.rand((batch, 1, 1, cfg.channels), generator=gen)
    img = base[..., None] * col
    img = img + cfg.noise * torch.randn(img.shape, generator=gen)
    img = torch.clamp(0.5 * (img + 1.0), 0.0, 1.0)
    return {"images": img.to(torch.float32).to(device),
            "labels": labels.to(device)}
