"""Table-II crossbar weight quantisation (``repro.core.aimc``, lines 37-77).

Only the digital datapath's pieces: the 5-bit differential-pair level
count, the per-column scale and the integer levels.  Both are exact in
torch: IEEE division, and ``torch.round`` rounds half to even as
``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AIMCConfig:
    weight_bits: int = 5  # differential pair => ~5-bit effective weight

    @property
    def levels(self) -> int:
        return 2 ** (self.weight_bits - 1) - 1  # +/-15 for 5-bit differential


def column_scale(w: Tensor, cfg: AIMCConfig) -> Tensor:
    """Per-output-column scale over ``[..., d_in, d_out]``: the column's
    max ``|w|`` maps to ``cfg.levels``."""
    amax = torch.amax(torch.abs(w), dim=-2)
    return torch.where(amax > 0, amax / cfg.levels, torch.ones_like(amax))


def quantize_levels(w: Tensor, scale: Tensor, cfg: AIMCConfig) -> Tensor:
    """Signed integer conductance-pair levels in ``[-levels, levels]``."""
    return torch.clamp(torch.round(w / scale[..., None, :]),
                       -cfg.levels, cfg.levels)
