"""Error-feedback int8 gradient compression: a twin of
``repro.optim.compression``.

``compress_decompress`` is the quantise -> dequantise round trip the train
step applies to the (reduced) gradients, with an error-feedback residual
that re-injects the quantisation error on the next step (Karimireddy et
al., "Error Feedback Fixes SignSGD").  Leaves of more than 4,096
elements and two or more axes quantise per row (last axis) to int8 with
a float32 scale; smaller leaves pass through.  The residuals are
bfloat16.  The arithmetic is XLA's in the reference's jitted step on the
CPU: ``/ 127`` a product with the reciprocal, the residual ``g - q
scale`` one fused multiply-add.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as TR
from repro_torch.core.aimc import fma, mul_reciprocal

Tensor = torch.Tensor


def init_ef_state(params: Any) -> Any:
    """Zero error-feedback residuals (the grads' shapes, bfloat16)."""
    return TR.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                             device=p.device), params)


def _q_roundtrip(x: Tensor):
    """-> ``(q * scale, q, scale)``; small leaves pass through
    uncompressed (``(x, None, None)``)."""
    if x.dim() < 2 or x.numel() <= 4096:
        return x, None, None
    amax = torch.amax(torch.abs(x), dim=-1)
    scale = torch.where(amax > 0, mul_reciprocal(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q * scale[..., None], q, scale


def compress_decompress(grads: Any, ef_state: Any) -> Tuple[Any, Any]:
    """EF-int8 round trip -> ``(compressed grads, new residuals)``."""
    flat_g, structure = TR.flatten(grads)
    flat_e = TR.flatten_up_to(structure, ef_state)
    comp, resid = [], []
    for g, e in zip(flat_g, flat_e):
        gf = g.to(torch.float32) + e.to(torch.float32)
        c, q, scale = _q_roundtrip(gf)
        comp.append(c.to(g.dtype))
        # the residual as XLA fuses it: gf - q*scale in one rounding
        resid.append((gf - c if q is None else fma(-q, scale[..., None], gf)
                      ).to(e.dtype))
    return TR.unflatten(structure, comp), TR.unflatten(structure, resid)
