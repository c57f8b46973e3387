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

On a training mesh each rank compresses its cut of each gradient:
whether a leaf quantises is decided by the whole leaf, and a row whose
last axis is cut takes its scale from the whole row, the maximum over the
ranks that hold its pieces.
"""

from __future__ import annotations

from typing import Any, Tuple

import math

import torch

from repro_torch import tree as TR
from repro_torch.core.aimc import fma, mul_reciprocal

Tensor = torch.Tensor


def init_ef_state(params: Any) -> Any:
    """Zero error-feedback residuals (the grads' shapes, bfloat16)."""
    return TR.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                             device=p.device), params)


def _q_roundtrip(x: Tensor, whole_numel: int = 0, row_max=None):
    """-> ``(q * scale, q, scale)``; small leaves (``whole_numel``: the
    whole leaf's size, of which ``x`` is a piece) pass through
    uncompressed (``(x, None, None)``); ``row_max``: each row's maximum
    over the ranks that hold the row's pieces."""
    if x.dim() < 2 or (whole_numel or x.numel()) <= 4096:
        return x, None, None
    amax = torch.amax(torch.abs(x), dim=-1)
    if row_max is not None:
        amax = row_max(amax)
    scale = torch.where(amax > 0, mul_reciprocal(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q * scale[..., None], q, scale


def compress_decompress(grads: Any, ef_state: Any, *, cuts=None, mesh=None
                        ) -> Tuple[Any, Any]:
    """EF-int8 round trip -> ``(compressed grads, new residuals)``.
    ``cuts``/``mesh``: a training rank's pieces, each leaf's ``(axes,
    last_axis)`` (:func:`repro_torch.parallel.sharding.leaf_cuts`)."""
    flat_g, structure = TR.flatten(grads)
    flat_e = TR.flatten_up_to(structure, ef_state)
    comp, resid = [], []
    for i, (g, e) in enumerate(zip(flat_g, flat_e)):
        axes, last = cuts[i] if cuts else ((), None)
        whole = g.numel() * math.prod(mesh.axis_size(a) for a in axes)
        row_max = (None if last is None else lambda amax: mesh.all_reduce(
            amax.clone(), (last,), torch.distributed.ReduceOp.MAX))
        gf = g.to(torch.float32) + e.to(torch.float32)
        c, q, scale = _q_roundtrip(gf, whole, row_max)
        comp.append(c.to(g.dtype))
        # the residual as XLA fuses it: gf - q*scale in one rounding
        resid.append((gf - c if q is None else fma(-q, scale[..., None], gf)
                      ).to(e.dtype))
    return TR.unflatten(structure, comp), TR.unflatten(structure, resid)
