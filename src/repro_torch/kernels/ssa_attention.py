"""K2 launcher: one SSA query row per (slot, t, head) (``csrc/ssa_attention.cu``).

Replaces ``repro/kernels/ssa_attention.py:ssa_decode_kernel``.  On a CPU
tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.ssa_decode_ref`); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels import ref as KREF

Tensor = torch.Tensor
_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    fn = KB.load("ssa_attention").launch_ssa_decode
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
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
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), rs.data_ptr(),
                 ra.data_ptr(), out.data_ptr(), g, l, d, KB.stream_ptr(q))
    KB.raise_on_error(err, "ssa_decode")
    KB.LAUNCHES["ssa_decode"] += 1
    return out
