"""Analog in-memory computing (AIMC) configuration and crossbar helpers.

Twin of ``repro.core.aimc`` (lines 37-77 and the forward of ``_adc``,
lines 139-146): the Table-II configuration of the PCM crossbars, the
per-column scale and integer levels of the digital datapath, and the
shared ADC that digitises a 128-row block's column partial sums on the
analog path.  Division is IEEE in both packages, and ``torch.round``
rounds half to even as ``jnp.round`` does, so all three are exact.  A
divisor that is a constant goes in as a tensor on the dividend's device
(:func:`div_const`): on CUDA, PyTorch turns division by a Python number
into multiplication by its rounded reciprocal, which is off by one ulp
for some quotients.

The ADC's straight-through gradient belongs to hardware-aware training,
which is not ported (ROADMAP A11): :func:`_adc` is the forward only.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AIMCConfig:
    """A copy of ``repro.core.aimc.AIMCConfig`` (paper Table II)."""

    conductance_bits: int = 4  # per PCM device
    weight_bits: int = 5  # differential pair => ~5-bit effective weight
    crossbar_rows: int = 128
    crossbar_cols: int = 128
    adc_bits: int = 5
    adc_sharing: int = 8
    # non-idealities (relative to per-column g_max)
    prog_noise_sigma: float = 0.03
    read_noise_sigma: float = 0.015
    # PCM drift (Joshi et al. 2020): nu ~ N(0.06, 0.02), t0 = 20 s
    drift_nu_mean: float = 0.06
    drift_nu_sigma: float = 0.02
    drift_t0_s: float = 20.0
    # ADC full-scale: multiple of g_max (expected partial-sum amplitude)
    adc_fullscale_rows: float = 8.0

    @property
    def levels(self) -> int:
        return 2 ** (self.weight_bits - 1) - 1  # +/-15 for 5-bit differential


def div_const(x: Tensor, c: float) -> Tensor:
    """``x / c`` correctly rounded on every device (see the module
    docstring)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def column_scale(w: Tensor, cfg: AIMCConfig) -> Tensor:
    """Per-output-column scale over ``[..., d_in, d_out]``: the column's
    max ``|w|`` maps to ``cfg.levels``."""
    amax = torch.amax(torch.abs(w), dim=-2)
    return torch.where(amax > 0, div_const(amax, cfg.levels),
                       torch.ones_like(amax))


def quantize_levels(w: Tensor, scale: Tensor, cfg: AIMCConfig) -> Tensor:
    """Signed integer conductance-pair levels in ``[-levels, levels]``."""
    return torch.clamp(torch.round(w / scale[..., None, :]),
                       -cfg.levels, cfg.levels)


def _adc(x: Tensor, cfg: AIMCConfig) -> Tensor:
    """The shared ADC on column partial sums (one 128-row block each): full
    scale ``+-adc_fullscale_rows * levels``, ``2**adc_bits`` uniform levels,
    ``round(x / step) * step`` in f32."""
    fs = cfg.adc_fullscale_rows * cfg.levels
    step = 2.0 * fs / (2 ** cfg.adc_bits - 1)
    q = torch.clamp(torch.round(div_const(x, step)), -(2 ** (cfg.adc_bits - 1)),
                    2 ** (cfg.adc_bits - 1) - 1)
    return q * step
