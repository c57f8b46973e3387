"""K2, K7 and K8 launchers (``csrc/ssa_attention.cu``): one SSA query row
per (slot, t, head) over a dense cache (K2) or a block-paged pool (K7),
and the full N x N SSA tile per (t, b, h) of a whole sequence (K8).

Replace ``repro/kernels/ssa_attention.py:ssa_decode_kernel``,
``ssa_decode_paged_kernel`` and ``ssa_attention_kernel``.  On a CPU tensor
each wrapper runs its plain version
(:func:`repro_torch.kernels.ref.ssa_decode_ref`,
:func:`~repro_torch.kernels.ref.ssa_decode_paged_ref`,
:func:`~repro_torch.kernels.ref.ssa_attention_ref`); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels import ref as KREF

Tensor = torch.Tensor
_P, _I = ctypes.c_void_p, ctypes.c_int


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
    if d > 512:
        raise ValueError(f"ssa_decode: D={d} > 512 lanes")
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
    if d > 512 or h % kv:
        raise ValueError(f"ssa_decode_paged: D={d} > 512 lanes or H={h} "
                         f"not a multiple of KV={kv}")
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


def ssa_attention_kernel(q: Tensor, k: Tensor, v: Tensor, rs: Tensor,
                         ra: Tensor, *, causal: bool = False) -> Tensor:
    """``q``/``k``/``v [G,N,D]`` uint8 spikes, ``rs [G,N,N]``, ``ra
    [G,N,D]`` int32 -> uint8 ``[G,N,D]``; ``N``, ``D`` up to 512."""
    if not q.is_cuda:
        return KREF.ssa_attention_ref(q, k, v, rs, ra, causal=causal)
    g, n, d = q.shape
    if not (0 < n <= 512 and 0 < d <= 512):
        raise ValueError(f"ssa_attention: N={n} and D={d} must lie in [1, 512]")
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        KB.check_cuda(x, torch.uint8, (g, n, d), name)
    KB.check_cuda(rs, torch.int32, (g, n, n), "rs")
    KB.check_cuda(ra, torch.int32, (g, n, d), "ra")
    out = torch.empty((g, n, d), dtype=torch.uint8, device=q.device)
    if g == 0:
        return out
    err = _lib("launch_ssa_attention", [_P] * 6 + [_I] * 4 + [_P])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rs.data_ptr(),
        ra.data_ptr(), out.data_ptr(), g, n, d, int(causal), KB.stream_ptr(q))
    KB.raise_on_error(err, "ssa_attention")
    KB.LAUNCHES["ssa_attention"] += 1
    return out
