"""Public kernel wrappers: layouts, comparator draws, launch or plain version.

Twins of ``repro.kernels.ops``.  What differs from the TPU wrappers: the
CUDA kernels read spike trains as stored (one uint8 per spike) and pack
them into uint32 lanes themselves, so padding ``hd`` and ``L`` to 32 lanes
happens inside the kernel (lanes and rows past the logical shape read as
zero, and a zero spike never beats a comparator draw).  The comparator
integers are drawn at the *logical* shapes here, as in the reference
(``ops.py:168-191``), so kernel and plain version see the same draws.
:func:`pack_bits` / :func:`unpack_bits` keep the reference's packing
convention (bit ``i`` of word ``w`` is element ``32 w + i``) for callers
that hold packed trains.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch import prng
from repro_torch.kernels import aimc_matmul as KA
from repro_torch.kernels import ssa_attention as KS

Tensor = torch.Tensor


def pack_bits(x: Tensor, dim: int = -1) -> Tensor:
    """Pack a binary tensor along ``dim`` (size % 32 == 0) into words held
    as int64 (uint32 values)."""
    x = x.movedim(dim, -1)
    *lead, n = x.shape
    xr = x.reshape(*lead, n // 32, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=x.device) << torch.arange(
        32, device=x.device)
    return (xr * weights).sum(-1).movedim(-1, dim)


def unpack_bits(x: Tensor, n: int, dim: int = -1) -> Tensor:
    """Inverse of :func:`pack_bits`, cut to ``n`` elements, as uint8."""
    xm = x.movedim(dim, -1).to(torch.int64)
    bits = (xm[..., :, None] >> torch.arange(32, device=x.device)) & 1
    out = bits.reshape(*xm.shape[:-1], xm.shape[-1] * 32)[..., :n]
    return out.to(torch.uint8).movedim(-1, dim)


def draw_comparator_prns(key: Tensor, shape_s: Tuple[int, ...],
                         shape_a: Tuple[int, ...], d: int, n: int
                         ) -> Tuple[Tensor, Tensor]:
    """``r_s ~ U{0..d-1}``, ``r_a ~ U{0..n-1}`` from one key (split in
    two), vectorised over the key's leading axes."""
    k = prng.split(key)
    rs = prng.randint(k[..., 0, :], shape_s, 0, d)
    ra = prng.randint(k[..., 1, :], shape_a, 0, n)
    return rs, ra


def draw_slot_decode_prns(slot_keys: Tensor, t: int, h: int, l: int, d: int,
                          i_max: int, h0: Union[int, Tensor] = 0
                          ) -> Tuple[Tensor, Tensor]:
    """Per-(slot, global head) comparator integers for one decode step.

    Each slot draws from its own key and each head from ``fold_in(slot_key,
    h0 + head)``, so a stream is ``f(seed, pos, head)`` and never depends
    on the other slots in the batch.  Returns ``rs [B,T*H,1,L]``, ``ra
    [B,T*H,1,D]``, t-major over the ``T*H`` axis."""
    b = slot_keys.shape[0]
    heads = torch.as_tensor(h0, dtype=torch.int64, device=slot_keys.device) \
        + torch.arange(h, dtype=torch.int64, device=slot_keys.device)
    kh = prng.fold_in(slot_keys[:, None, :], heads[None, :])  # [B,H,2]
    rs, ra = draw_comparator_prns(kh, (t, 1, l), (t, 1, d), d, i_max)
    return (rs.movedim(1, 2).reshape(b, t * h, 1, l),
            ra.movedim(1, 2).reshape(b, t * h, 1, d))


def ssa_attention_decode_packed(q: Tensor, k: Tensor, v: Tensor,
                                slot_keys: Tensor,
                                h0: Union[int, Tensor] = 0, *, i_max: int
                                ) -> Tensor:
    """SSA decode step: ``q [T,B,H,1,D]`` against ``k``/``v [T,B,H,L,D]``
    (zeros beyond each slot's position) -> uint8 ``[T,B,H,1,D]``.

    Comparator draws per (slot, global head) at the logical shapes; the
    kernel runs one query row per ``g = (b, t, h)``."""
    t, b, h, _, d = q.shape
    l = k.shape[3]
    rs, ra = draw_slot_decode_prns(slot_keys, t, h, l, d, i_max, h0)
    g = b * t * h
    qf = q.movedim(1, 0).reshape(g, 1, d).to(torch.uint8).contiguous()
    kf = k.movedim(1, 0).reshape(g, l, d).to(torch.uint8).contiguous()
    vf = v.movedim(1, 0).reshape(g, l, d).to(torch.uint8).contiguous()
    out = KS.ssa_decode_kernel(qf, kf, vf, rs.reshape(g, 1, l),
                               ra.reshape(g, 1, d))
    return out.reshape(b, t, h, 1, d).movedim(0, 1)


def aimc_spiking_linear(spikes: Tensor, w_levels: Tensor, scale: Tensor,
                        bias: Optional[Tensor] = None, *, beta: float = 0.5,
                        v_thresh: float = 1.0) -> Tensor:
    """``LIF(W s^t * scale + bias)`` over ``[T, B, d_in]`` integer-valued
    spikes -> uint8 ``[T, B, d_out]``; bias ``None`` adds nothing."""
    return KA.aimc_spiking_linear_kernel(
        spikes.to(torch.float32), w_levels.to(torch.int8),
        scale.to(torch.float32),
        None if bias is None else bias.to(torch.float32),
        beta=beta, v_thresh=v_thresh)
