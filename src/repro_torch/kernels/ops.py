"""Public kernel wrappers: layouts, comparator draws, launch or plain version.

Twins of ``repro.kernels.ops``.  What differs from the TPU wrappers: the
CUDA kernels read spike trains as stored (one uint8 per spike) and pack
them into uint32 lanes themselves, so padding ``hd`` and ``L`` to 32 lanes
happens inside the kernel (lanes and rows past the logical shape read as
zero, and a zero spike never beats a comparator draw).  The comparator
integers are drawn at the *logical* shapes, as in the reference
(``ops.py:168-191``), so kernel and plain version see the same draws:
here through the threefry twin, or, on the card, by the keyed K8 from the
block's key (:func:`draw_comparator_prns`'s chain) and by the keyed K2 and
K7 from the slot keys
(:func:`~repro_torch.kernels.ref.draw_slot_decode_prns`'s chain).
:func:`pack_bits` / :func:`unpack_bits` keep the reference's packing
convention (bit ``i`` of word ``w`` is element ``32 w + i``) for callers
that hold packed trains.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import aimc_matmul as KA
from repro_torch.kernels import build as KB
from repro_torch.kernels import lif as KL
from repro_torch.kernels import ref as KREF
from repro_torch.kernels import ssa_attention as KS
from repro_torch.kernels.ref import draw_comparator_prns, draw_slot_decode_prns

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


def ssa_attention_packed(q: Tensor, k: Tensor, v: Tensor, key: Tensor, *,
                         causal: bool = False, b0: int = 0, h0: int = 0,
                         batch: Optional[int] = None,
                         heads: Optional[int] = None) -> Tensor:
    """Full-sequence SSA over ``q``/``k``/``v [T,B,H,N,D]`` spike trains ->
    uint8 ``[T,B,H,N,D]``; a mesh rank's block of a ``[T, batch, heads]``
    grid of tiles, from batch row ``b0`` and head ``h0``, draws the whole
    grid's comparators at its own tiles (the defaults: the whole grid).

    The comparator integers ``rs [G,N,N] ~ U{0..D-1}`` and ``ra [G,N,D] ~
    U{0..N-1}`` are those :func:`draw_comparator_prns` draws from ``key``
    at the logical shapes, with the tiles flattened ``G = (t, b, h)`` in
    that order, as the reference's wrapper draws them (``ops.py:83``).  On
    the card the keyed K8 draws them in registers, reads q, k and v through
    their strides (the heads view of a ``[T,B,N,H*hd]`` train: no copy)
    and returns the heads view of a ``[T,B,N,H,hd]`` buffer, which merges
    back into the train without a copy; on the CPU the plain version draws
    them with the threefry twin."""
    return KS.ssa_attention_keyed_kernel(q, k, v, key, causal=causal, b0=b0,
                                         h0=h0, batch=batch, heads=heads)


def lif_fused(currents: Tensor, *, beta: float = 0.5, v_thresh: float = 1.0
              ) -> Tensor:
    """The LIF neuron over ``[T, ...]`` currents -> uint8 spikes of the
    same shape (K4 over the flattened ``[T, M]``)."""
    t = currents.shape[0]
    flat = currents.to(torch.float32).reshape(t, -1).contiguous()
    return KL.lif_kernel(flat, beta=beta, v_thresh=v_thresh).reshape(
        currents.shape)


def lif_counts_fused(counts: Tensor, scale: Tensor, bias: Optional[Tensor],
                     *, beta: float = 0.5, v_thresh: float = 1.0) -> Tensor:
    """A row-parallel linear's epilogue, ``LIF(counts * scale + bias)``
    over integer-valued ``counts [T, M, N]`` -> uint8 ``[T, M, N]``, as one
    K4 launch (the product and the sum rounded separately); ``bias``
    ``None`` adds nothing.  Operands already f32 and contiguous pass
    through untouched."""
    f32 = torch.float32
    return KL.lif_counts_kernel(
        KB.conform(counts, f32), KB.conform(scale, f32),
        None if bias is None else KB.conform(bias, f32),
        beta=beta, v_thresh=v_thresh)


def ssa_attention_decode_packed(q: Tensor, k: Tensor, v: Tensor,
                                slot_keys: Tensor,
                                h0: Union[int, Tensor] = 0, *, i_max: int,
                                pos: Optional[Tensor] = None) -> Tensor:
    """SSA decode step: ``q [T,B,H,1,D]`` against ``k``/``v [T,B,H,L,D]``
    (zeros at and beyond each slot's live length ``pos [B]``) -> uint8
    ``[T,B,H,1,D]``.

    The comparator integers are those of :func:`draw_slot_decode_prns`
    (per slot and global head, at the logical shapes).  On the card the
    keyed K2 draws them in registers, reads the cache through its strides
    (the serving path's permuted view, no copy) and stops each slot's
    scores at ``pos``; on the CPU the plain version draws them with the
    threefry twin and reads every row."""
    return KS.ssa_decode_keyed_kernel(q, k, v, slot_keys, pos, h0=h0,
                                      i_max=i_max)


def gather_kv_pages(pool: Tensor, page_table: Tensor) -> Tensor:
    """Paged pool ``[P, T, KV, page_len, d]`` + ``page_table [B, MP]`` ->
    the dense per-slot view ``[T, B, KV, MP*page_len, d]`` (page ``table[b,
    j]`` at logical positions ``[j*page_len, (j+1)*page_len)``; entry 0 is
    the zero null page).  The plain versions' path: no kernel gathers."""
    return KREF.gather_kv_pages_ref(pool, page_table)


def ssa_attention_decode_paged_packed(q: Tensor, kpool: Tensor,
                                      vpool: Tensor, page_table: Tensor,
                                      slot_keys: Tensor,
                                      h0: Union[int, Tensor] = 0, *,
                                      i_max: int,
                                      pos: Optional[Tensor] = None) -> Tensor:
    """Paged SSA decode step: ``q [T,B,H,1,D]`` against the page pools
    ``kpool``/``vpool [P,T,KV,page_len,D]`` through ``page_table [B,MP]``
    -> uint8 ``[T,B,H,1,D]``; ``pos [B]`` each slot's write position this
    step (the post-scatter rows past it are zero).

    The comparator integers are drawn per (slot, global head) at the
    *logical* cache length ``L = MP*page_len`` with the dense path's
    streams, so paged decode equals :func:`ssa_attention_decode_packed`
    over the gathered cache.  On the card the keyed K7 draws them in
    registers, reads each page through the table (query head ``h`` reads
    KV head ``h // (H/KV)``) and stops each slot's scores after ``pos``;
    q, the pools and the output stay where the caller holds them.  On the
    CPU the plain version draws with the threefry twin and reads every
    row."""
    return KS.ssa_decode_paged_keyed_kernel(q, kpool, vpool, page_table,
                                            slot_keys, pos, h0=h0,
                                            i_max=i_max)


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


def aimc_matmul_counts(spikes: Tensor, w_levels: Tensor) -> Tensor:
    """The integer crossbar counts ``W s^t`` of ``[T, M, d_in]``
    integer-valued spikes as f32 ``[T, M, d_out]`` (K5): no scale, bias or
    LIF."""
    return KA.aimc_matmul_counts_kernel(
        spikes.to(torch.float32).contiguous(),
        w_levels.to(torch.int8).contiguous())
