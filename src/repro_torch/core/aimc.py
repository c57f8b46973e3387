"""Analog in-memory computing (AIMC) configuration and crossbar helpers.

Twin of ``repro.core.aimc`` (lines 37-93, 139-153 and 200-206): the
Table-II configuration of the PCM crossbars, the per-column scale and
integer levels of the digital datapath, the shared ADC that digitises a
128-row block's column partial sums on the analog path (straight-through
gradient), and hardware-aware training's noisy weights
(:func:`hwat_weights`: quantisation plus programming noise forward, the
ideal weight's gradient backward).  Division is IEEE in both packages, and ``torch.round``
rounds half to even as ``jnp.round`` does, so all three are exact.  A
divisor that is a constant goes in as a tensor on the dividend's device
(:func:`div_const`): on CUDA, PyTorch turns division by a Python number
into multiplication by its rounded reciprocal, which is off by one ulp
for some quotients.

:func:`_ste` returns the noisy operand itself (not ``w + (w_eff -
w).detach()``, which is not bitwise ``w_eff``).  :func:`hwat_weights`
runs in the reference's jitted training step, where XLA turns the column
scale's division by ``levels`` into a product with the float32
reciprocal; it takes that product (:func:`mul_reciprocal`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import prng

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


def mul_reciprocal(x: Tensor, c: float) -> Tensor:
    """``x / c`` as XLA computes a division by a constant under ``jit``:
    ``x * (1 / c)`` with the reciprocal rounded to float32 first (a
    float32 division of CPU tensors, then a product with a float32-exact
    scalar: no copy to the card)."""
    r = torch.ones((), dtype=torch.float32) / torch.tensor(float(c))
    return x * r.item()


def fma(a, b, c: Tensor) -> Tensor:
    """``a * b + c`` rounded once to float32, as XLA's fused loops on the
    CPU contract a product into the sum that reads it first (the product
    of two float32 values is exact in float64; the sum is rounded there,
    then to float32).  For the reference's jitted training step, whose
    optimizer and noise updates are such loops."""
    def f64(x):
        return x.double() if isinstance(x, Tensor) else x

    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


class STE(torch.autograd.Function):
    """``_ste(w, w_eff)``: forward ``w_eff`` itself, backward the gradient
    to ``w`` (the ideal float weight) and none to ``w_eff``."""

    @staticmethod
    def forward(ctx, w: Tensor, w_eff: Tensor) -> Tensor:
        return w_eff

    @staticmethod
    def backward(ctx, g: Tensor):
        return g, None


def _ste(w: Tensor, w_eff: Tensor) -> Tensor:
    return STE.apply(w, w_eff)


def _adc(x: Tensor, cfg: AIMCConfig) -> Tensor:
    """The shared ADC on column partial sums (one 128-row block each): full
    scale ``+-adc_fullscale_rows * levels``, ``2**adc_bits`` uniform levels,
    ``round(x / step) * step`` in f32, straight-through to ``x``."""
    fs = cfg.adc_fullscale_rows * cfg.levels
    step = 2.0 * fs / (2 ** cfg.adc_bits - 1)
    q = torch.clamp(torch.round(div_const(x.detach(), step)),
                    -(2 ** (cfg.adc_bits - 1)), 2 ** (cfg.adc_bits - 1) - 1)
    return _ste(x, q * step)


def hwat_weights(key: Tensor, w: Tensor, cfg: AIMCConfig) -> Tensor:
    """Hardware-aware training's weights: per-column quantisation to
    ``cfg.levels`` plus programming noise ``prog_noise_sigma * levels *
    normal(key)`` (the twin's normals: ``erfinv`` is a float boundary),
    times the scale; the gradient goes straight through to ``w``."""
    return hwat_from_erfinv(
        w, prng.normal_erfinv(key.to(w.device), tuple(w.shape)), cfg)


def hwat_from_erfinv(w: Tensor, e: Tensor, cfg: AIMCConfig) -> Tensor:
    """:func:`hwat_weights` given ``e = erfinv(u)`` of its normals
    (``normal = sqrt(2) e``).  The noisy level is computed as XLA computes
    it in the reference's jitted step: the constants folded into one
    float32 factor ``c = f32(sigma * levels) * f32(sqrt 2)``, and ``levels
    + e c`` contracted into one fused multiply-add (the product of two
    float32 values is exact in float64, the sum rounded once)."""
    wd = w.detach()
    amax = torch.amax(torch.abs(wd), dim=-2)
    scale = torch.where(amax > 0, mul_reciprocal(amax, cfg.levels),
                        torch.ones_like(amax))
    levels = quantize_levels(wd, scale, cfg)
    c = (torch.tensor(cfg.prog_noise_sigma * cfg.levels, dtype=torch.float32)
         * torch.tensor(math.sqrt(2.0), dtype=torch.float32)).item()
    return _ste(w, (fma(e, c, levels) * scale).to(w.dtype))
