"""Table-II weight quantisation: ``repro.aimc_device.quantize_weights``.

The single entry point the backends use to turn float weights into
crossbar operands.  The programmed-PCM lifecycle (drift, GDC) is not part
of this slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import aimc as AM
from repro_torch.core.aimc import AIMCConfig

Tensor = torch.Tensor


def quantize_weights(w: Tensor, cfg: AIMCConfig = AIMCConfig()
                     ) -> Tuple[Tensor, Tensor]:
    """Float weights ``[..., d_in, d_out]`` -> (integer levels as float,
    float32 column scale); every leading axis quantises independently."""
    w = w.to(torch.float32)
    scale = AM.column_scale(w, cfg)
    return AM.quantize_levels(w, scale, cfg), scale
