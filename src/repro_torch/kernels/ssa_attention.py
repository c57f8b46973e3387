"""K2, K7 and K8 launchers (``csrc/ssa_attention.cu``): one SSA query row
per (slot, t, head) over a dense cache (K2) or a block-paged pool (K7),
and the full N x N SSA tile per (t, b, h) of a whole sequence (K8).

Replace ``repro/kernels/ssa_attention.py:ssa_decode_kernel``,
``ssa_decode_paged_kernel`` and ``ssa_attention_kernel``.  Each has two
entries over one kernel body: :func:`ssa_decode_kernel`,
:func:`ssa_decode_paged_kernel` and :func:`ssa_attention_kernel` take
their comparator draws as tensors; :func:`ssa_decode_keyed_kernel` and
:func:`ssa_decode_paged_keyed_kernel` (the serving paths') draw them
themselves from the slot keys, take the query and the cache where the
caller holds them and read up to each slot's live length, and
:func:`ssa_attention_keyed_kernel` (the paper forwards') draws them from
one key and reads and writes the heads where the caller holds them.  On a
CPU tensor each wrapper runs its plain version
(:func:`repro_torch.kernels.ref.ssa_decode_ref`,
:func:`~repro_torch.kernels.ref.ssa_decode_keyed_ref`,
:func:`~repro_torch.kernels.ref.ssa_decode_paged_ref`,
:func:`~repro_torch.kernels.ref.ssa_decode_paged_keyed_ref`,
:func:`~repro_torch.kernels.ref.ssa_attention_ref`,
:func:`~repro_torch.kernels.ref.ssa_attention_keyed_ref`); on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Union

import torch

from repro_torch import prng
from repro_torch.kernels import build as KB
from repro_torch.kernels import ref as KREF

Tensor = torch.Tensor
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# launch_ssa_attention_keyed's parameters: q, k, v, key, out, the host
# strides; T, B, H, N, D, causal, the tiles' place (b0, h0) in the (batch,
# heads) grid drawn, the spans' multipliers and xpk_fastmod constants; the
# plan's rows, keys and shared memory; the stream
KEYED_ARGTYPES = ([_P] * 5 + [ctypes.POINTER(ctypes.c_longlong)] + [_I] * 11
                  + [ctypes.c_ulonglong, _I, ctypes.c_ulonglong, _I, _I, _L,
                     _P])


def _lib(name: str, argtypes):
    fn = getattr(KB.load("ssa_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def ssa_decode_kernel(q: Tensor, k: Tensor, v: Tensor, rs: Tensor,
                      ra: Tensor) -> Tensor:
    """``q [G,1,D]``, ``k``/``v [G,L,D]`` uint8 spikes, ``rs [G,1,L]``,
    ``ra [G,1,D]`` int32 -> uint8 ``[G,1,D]``."""
    if not q.is_cuda:
        return KREF.ssa_decode_ref(q, k, v, rs, ra)
    g, l, d = k.shape
    KB.check_cuda(q, torch.uint8, (g, 1, d), "q")
    KB.check_cuda(k, torch.uint8, (g, l, d), "k")
    KB.check_cuda(v, torch.uint8, (g, l, d), "v")
    KB.check_cuda(rs, torch.int32, (g, 1, l), "rs")
    KB.check_cuda(ra, torch.int32, (g, 1, d), "ra")
    out = torch.empty((g, 1, d), dtype=torch.uint8, device=q.device)
    err = _lib("launch_ssa_decode", [_P] * 6 + [_I] * 3 + [_P])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rs.data_ptr(),
        ra.data_ptr(), out.data_ptr(), g, l, d, KB.stream_ptr(q))
    KB.raise_on_error(err, "ssa_decode")
    KB.LAUNCHES["ssa_decode"] += 1
    return out


def ssa_decode_keyed_kernel(q: Tensor, k: Tensor, v: Tensor,
                            slot_keys: Tensor, pos: Optional[Tensor], *,
                            h0: Union[int, Tensor] = 0, i_max: int) -> Tensor:
    """The SSA decode row drawing its own comparators: ``q [T,B,H,1,D]``
    uint8 (contiguous), ``k``/``v [T,B,H,L,D]`` uint8 with contiguous rows
    and equal strides (a permuted cache: no copy), ``slot_keys [B, 2]``
    int64 holding uint32 words, ``pos [B]`` int32 each slot's live length
    (rows at and past it are zero and are not read) or ``None`` (all L) ->
    uint8 ``[T,B,H,1,D]``.  Query row ``(b, t, h)`` draws from
    ``fold_in(slot_keys[b], h0 + h)`` what
    :func:`repro_torch.kernels.ref.draw_slot_decode_prns` draws, score
    comparators in ``[0, D)`` and output comparators in ``[0, i_max)``."""
    if not q.is_cuda:
        return KREF.ssa_decode_keyed_ref(q, k, v, slot_keys, h0, i_max=i_max)
    t, b, h, l, d = k.shape
    KB.check_cuda(q, torch.uint8, (t, b, h, 1, d), "q")
    for x, name in ((k, "k"), (v, "v")):
        if not x.is_cuda or x.dtype != torch.uint8 or x.stride(4) != 1:
            raise ValueError(f"ssa_decode_keyed: {name} must be uint8 on the "
                             "card with contiguous rows")
    if v.shape != k.shape or v.stride() != k.stride():
        raise ValueError("ssa_decode_keyed: k and v differ in shape or "
                         f"strides: {tuple(k.stride())}, {tuple(v.stride())}")
    KB.check_cuda(slot_keys, torch.int64, (b, 2), "slot_keys")
    if pos is not None:
        KB.check_cuda(pos, torch.int32, (b,), "pos")
    out = torch.empty((t, b, h, 1, d), dtype=torch.uint8, device=q.device)
    if out.numel() == 0:
        return out
    st, sb, sh, sl, _ = k.stride()
    err = _lib("launch_ssa_decode_keyed", [_P] * 6 + [_I] * 6 + [_L] * 4
               + [_I] * 4 + [_P])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_keys.data_ptr(),
        0 if pos is None else pos.data_ptr(), out.data_ptr(), b, t, h, l, d,
        int(h0), st, sb, sh, sl, d, prng.randint_multiplier(d), i_max,
        prng.randint_multiplier(i_max), KB.stream_ptr(q))
    KB.raise_on_error(err, "ssa_decode_keyed")
    KB.LAUNCHES["ssa_decode"] += 1
    return out


def ssa_decode_paged_kernel(q: Tensor, kpool: Tensor, vpool: Tensor,
                            page_table: Tensor, rs: Tensor, ra: Tensor
                            ) -> Tensor:
    """``q [B,T,H,D]`` uint8 spikes, page pools ``kpool``/``vpool
    [P,T,KV,page_len,D]`` uint8, ``page_table [B,MP]`` int32 (page 0 is
    the zero null page), ``rs [B,T*H,1,MP*page_len]``, ``ra [B,T*H,1,D]``
    int32 -> uint8 ``[B,T,H,D]``.  Query head ``h`` reads KV head ``h //
    (H/KV)``.  The kernel reads pages through the table and trusts its
    entries to lie in ``[0, P)``."""
    b, t, h, d = q.shape
    p, _, kv, page_len, _ = kpool.shape
    mp = page_table.shape[1]
    l = mp * page_len
    if not q.is_cuda:
        out = KREF.ssa_decode_paged_ref(
            q[:, :, :, None, :], kpool, vpool, page_table,
            rs.reshape(b, t, h, 1, l), ra.reshape(b, t, h, 1, d))
        return out[:, :, :, 0, :]
    if h % kv:
        raise ValueError(f"ssa_decode_paged: H={h} is not a multiple of "
                         f"KV={kv}")
    KB.check_cuda(q, torch.uint8, (b, t, h, d), "q")
    KB.check_cuda(kpool, torch.uint8, (p, t, kv, page_len, d), "kpool")
    KB.check_cuda(vpool, torch.uint8, (p, t, kv, page_len, d), "vpool")
    KB.check_cuda(page_table, torch.int32, (b, mp), "page_table")
    KB.check_cuda(rs, torch.int32, (b, t * h, 1, l), "rs")
    KB.check_cuda(ra, torch.int32, (b, t * h, 1, d), "ra")
    out = torch.empty((b, t, h, d), dtype=torch.uint8, device=q.device)
    err = _lib("launch_ssa_decode_paged", [_P] * 7 + [_I] * 7 + [_P])(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
        page_table.data_ptr(), rs.data_ptr(), ra.data_ptr(), out.data_ptr(),
        b, t, h, kv, page_len, mp, d, KB.stream_ptr(q))
    KB.raise_on_error(err, "ssa_decode_paged")
    KB.LAUNCHES["ssa_decode_paged"] += 1
    return out


def ssa_decode_paged_keyed_kernel(q: Tensor, kpool: Tensor, vpool: Tensor,
                                  page_table: Tensor, slot_keys: Tensor,
                                  pos: Optional[Tensor], *,
                                  h0: Union[int, Tensor] = 0, i_max: int
                                  ) -> Tensor:
    """The paged SSA decode row drawing its own comparators: ``q
    [T,B,H,1,D]`` uint8 (contiguous), the pools ``kpool``/``vpool
    [P,T,KV,page_len,D]`` uint8 (contiguous, as stored: checked, never
    converted), ``page_table [B,MP]`` int32 (page 0 the zero null page),
    ``slot_keys [B, 2]`` int64 holding uint32 words, ``pos [B]`` int32 each
    slot's write position this step (its rows up to and including ``pos``
    are live, later ones zero and not read; ``pos >= L`` reads all ``L =
    MP*page_len``) or ``None`` (all L) -> uint8 ``[T,B,H,1,D]``.  Query row
    ``(b, t, h)`` draws from ``fold_in(slot_keys[b], h0 + h)`` what
    :func:`repro_torch.kernels.ref.draw_slot_decode_prns` draws at length
    ``L``; query head ``h`` reads KV head ``h // (H/KV)``.  The kernel
    trusts the table's entries to lie in ``[0, P)``."""
    if not q.is_cuda:
        return KREF.ssa_decode_paged_keyed_ref(q, kpool, vpool, page_table,
                                               slot_keys, h0, i_max=i_max)
    t, b, h, _, d = q.shape
    p, _, kv, page_len, _ = kpool.shape
    mp = page_table.shape[1]
    if h % kv:
        raise ValueError(f"ssa_decode_paged_keyed: H={h} is not a multiple "
                         f"of KV={kv}")
    KB.check_cuda(q, torch.uint8, (t, b, h, 1, d), "q")
    KB.check_cuda(kpool, torch.uint8, (p, t, kv, page_len, d), "kpool")
    KB.check_cuda(vpool, torch.uint8, (p, t, kv, page_len, d), "vpool")
    KB.check_cuda(page_table, torch.int32, (b, mp), "page_table")
    KB.check_cuda(slot_keys, torch.int64, (b, 2), "slot_keys")
    if pos is not None:
        KB.check_cuda(pos, torch.int32, (b,), "pos")
    out = torch.empty((t, b, h, 1, d), dtype=torch.uint8, device=q.device)
    if out.numel() == 0:
        return out
    err = _lib("launch_ssa_decode_paged_keyed", [_P] * 7 + [_I] * 12 + [_P])(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
        page_table.data_ptr(), slot_keys.data_ptr(),
        0 if pos is None else pos.data_ptr(), out.data_ptr(), b, t, h, kv,
        page_len, mp, d, int(h0), d, prng.randint_multiplier(d), i_max,
        prng.randint_multiplier(i_max), KB.stream_ptr(q))
    KB.raise_on_error(err, "ssa_decode_paged_keyed")
    KB.LAUNCHES["ssa_decode_paged"] += 1
    return out


SMEM_BUDGET = KB.SMEM_PER_BLOCK  # K8's kernels take no static shared memory
_TILE_WARPS = 8
_STREAM_COLS = 64  # V columns a chunk of the streaming design


class AttentionPlan(NamedTuple):
    """K8's design for one tile shape: ``"resident"`` (the whole packed
    tile in one block's shared memory) or ``"stream"`` (``rows`` query
    rows a block, K and V through shared memory ``keys`` sequence rows at
    a time), with the dynamic shared memory it needs, which the launcher
    checks against its buffers' layout."""
    design: str
    smem: int
    rows: int = 0
    keys: int = 0


@functools.lru_cache(maxsize=None)
def attention_plan(n: int, d: int) -> AttentionPlan:
    """The resident design where its ``(2 N ceil(D/32) + ceil(N/32) D + 8
    ceil(N/32))`` words fit in :data:`SMEM_BUDGET`, else the streaming one
    with the most query rows a block (64 down to 8) and keys a chunk (128
    down to 32) that fit; raises, naming the bytes, where none does."""
    wd, wn = -(-d // 32), -(-n // 32)
    smem = 4 * (2 * n * wd + wn * d + _TILE_WARPS * wn)
    if smem <= SMEM_BUDGET:
        return AttentionPlan("resident", smem)
    for nc in (128, 64, 32):
        for rq in (64, 32, 16, 8):
            smem = 4 * (rq * wd + rq * wn + max(wd * nc,
                                                nc // 32 * _STREAM_COLS))
            if smem <= SMEM_BUDGET:
                return AttentionPlan("stream", smem, rq, nc)
    raise ValueError(f"ssa_attention: N={n}, D={d} needs {smem} bytes of "
                     f"shared memory a block at its smallest chunks, past "
                     f"the card's {SMEM_BUDGET}")


def ssa_attention_kernel(q: Tensor, k: Tensor, v: Tensor, rs: Tensor,
                         ra: Tensor, *, causal: bool = False) -> Tensor:
    """``q``/``k``/``v [G,N,D]`` uint8 spikes, ``rs [G,N,N]``, ``ra
    [G,N,D]`` int32 -> uint8 ``[G,N,D]``, any ``N`` and ``D``
    (:func:`attention_plan` picks the design)."""
    if not q.is_cuda:
        return KREF.ssa_attention_ref(q, k, v, rs, ra, causal=causal)
    g, n, d = q.shape
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        KB.check_cuda(x, torch.uint8, (g, n, d), name)
    KB.check_cuda(rs, torch.int32, (g, n, n), "rs")
    KB.check_cuda(ra, torch.int32, (g, n, d), "ra")
    out = torch.empty((g, n, d), dtype=torch.uint8, device=q.device)
    if out.numel() == 0:
        return out
    plan = attention_plan(n, d)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), rs.data_ptr(),
            ra.data_ptr(), out.data_ptr())
    if plan.design == "resident":
        err = _lib("launch_ssa_attention", [_P] * 6 + [_I] * 4 + [_L, _P])(
            *ptrs, g, n, d, int(causal), plan.smem, KB.stream_ptr(q))
    else:
        err = _lib("launch_ssa_attention_stream",
                   [_P] * 6 + [_I] * 6 + [_L, _P])(
            *ptrs, g, n, d, int(causal), plan.rows, plan.keys, plan.smem,
            KB.stream_ptr(q))
    KB.raise_on_error(err, "ssa_attention")
    KB.LAUNCHES["ssa_attention"] += 1
    return out


def fastmod_m(span: int) -> int:
    """``csrc/threefry.cuh:xpk_fastmod``'s constant for ``span >= 1``:
    ``floor((2**64 - 1) / span) + 1`` wrapped to 64 bits (0 at span 1),
    with which ``x % span == (M * x mod 2**64) * span >> 64`` for every
    uint32 ``x``."""
    if span < 1:
        raise ValueError(f"fastmod_m: span {span} < 1")
    return ((2 ** 64 - 1) // span + 1) % 2 ** 64


def ssa_attention_keyed_kernel(q: Tensor, k: Tensor, v: Tensor, key: Tensor,
                               *, causal: bool = False, b0: int = 0,
                               h0: int = 0, batch: Optional[int] = None,
                               heads: Optional[int] = None) -> Tensor:
    """The full SSA tile drawing its own comparators: ``q``/``k``/``v
    [T,B,H,N,D]`` uint8 spikes, any strides with contiguous rows (the heads
    view of a ``[T,B,N,H*D]`` train: no copy), ``key [2]`` int64 holding
    uint32 words -> uint8 ``[T,B,H,N,D]``, the heads view of a contiguous
    ``[T,B,N,H,D]`` buffer (its heads merge back without a copy).  The
    comparators are :func:`repro_torch.kernels.ref.draw_comparator_prns`'s
    from ``key`` with the tiles flattened ``(t, b, h)`` over a ``[T,
    batch, heads]`` grid of which these tiles are the block from batch row
    ``b0`` and head ``h0`` (a mesh rank's share; the defaults are the whole
    grid); the kernel draws only those whose count is not zero (the others
    cannot fire).  :func:`attention_plan` picks the design."""
    tile = dict(b0=b0, h0=h0, batch=batch, heads=heads)
    if not q.is_cuda:
        return KREF.ssa_attention_keyed_ref(q, k, v, key, causal=causal,
                                            **tile)
    t, b, h, n, d = q.shape
    batch, heads = KREF.check_tile_block(b, h, b0, h0, batch, heads)
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        if (not x.is_cuda or x.dtype != torch.uint8 or x.shape != q.shape
                or (d > 1 and x.stride(4) != 1)):
            raise ValueError(f"ssa_attention_keyed: {name} must be uint8 on "
                             f"the card, of shape {tuple(q.shape)}, with "
                             "contiguous rows")
    KB.check_cuda(key, torch.int64, (2,), "key")
    out = torch.empty((t, b, n, h, d), dtype=torch.uint8,
                      device=q.device).permute(0, 1, 3, 2, 4)
    if out.numel() == 0:
        return out
    plan = attention_plan(n, d)
    strides = (ctypes.c_longlong * 16)(
        *(st for x in (q, k, v, out) for st in x.stride()[:4]))
    err = _lib("launch_ssa_attention_keyed", KEYED_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key.data_ptr(),
        out.data_ptr(), strides, t, b, h, n, d, int(causal), b0, h0, batch,
        heads,
        prng.randint_multiplier(d), fastmod_m(d), prng.randint_multiplier(n),
        fastmod_m(n), plan.rows, plan.keys, plan.smem, KB.stream_ptr(q))
    KB.raise_on_error(err, "ssa_attention_keyed")
    KB.LAUNCHES["ssa_attention_keyed"] += 1
    return out
