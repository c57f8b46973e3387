"""K4 launchers: the LIF neuron over the spike-time axis (``csrc/lif.cu``),
on given currents or behind a row-parallel linear's epilogue.

Replaces ``repro/kernels/lif.py:lif_kernel``.  On a CPU tensor each
wrapper runs its plain version (:func:`repro_torch.kernels.ref.lif_ref`,
:func:`~repro_torch.kernels.ref.lif_counts_ref`); on a CUDA tensor it
launches the kernel or raises.  Both entries count under
``LAUNCHES["lif"]``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels import ref as KREF

Tensor = torch.Tensor
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


_ARGTYPES = {"launch_lif": [_P, _P, _I, _L, _F, _F, _P],
             "launch_lif_counts": [_P, _P, _P, _P, _I, _L, _I, _F, _F, _P]}


def _lib(name: str = "launch_lif"):
    fn = getattr(KB.load("lif"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def lif_kernel(currents: Tensor, *, beta: float = 0.5, v_thresh: float = 1.0
               ) -> Tensor:
    """``currents [T, M]`` f32 -> uint8 spikes ``[T, M]``: ``v = beta v +
    i_t`` (each step rounded once), a spike where ``v >= v_thresh``, then
    reset to zero."""
    if not currents.is_cuda:
        return KREF.lif_ref(currents, beta=beta, v_thresh=v_thresh)
    t, m = currents.shape
    KB.check_cuda(currents, torch.float32, (t, m), "currents")
    out = torch.empty((t, m), dtype=torch.uint8, device=currents.device)
    if t == 0 or m == 0:
        return out
    err = _lib()(currents.data_ptr(), out.data_ptr(), t, m, beta, v_thresh,
                 KB.stream_ptr(currents))
    KB.raise_on_error(err, "lif")
    KB.LAUNCHES["lif"] += 1
    return out


def lif_counts_kernel(counts: Tensor, scale: Tensor, bias: Optional[Tensor],
                      *, beta: float = 0.5, v_thresh: float = 1.0) -> Tensor:
    """The row-parallel epilogue in one launch: integer-valued ``counts [T,
    M, N]`` f32, ``scale [N]`` and ``bias [N]`` f32 (or ``None``) -> uint8
    spikes ``[T, M, N]`` of ``LIF(counts * scale + bias)``, the product
    and the sum rounded separately."""
    if not counts.is_cuda:
        return KREF.lif_counts_ref(counts, scale, bias, beta=beta,
                                   v_thresh=v_thresh)
    t, m, n = counts.shape
    KB.check_cuda(counts, torch.float32, (t, m, n), "counts")
    KB.check_cuda(scale, torch.float32, (n,), "scale")
    if bias is not None:
        KB.check_cuda(bias, torch.float32, (n,), "bias")
    out = torch.empty((t, m, n), dtype=torch.uint8, device=counts.device)
    if out.numel() == 0:
        return out
    err = _lib("launch_lif_counts")(
        counts.data_ptr(), scale.data_ptr(),
        0 if bias is None else bias.data_ptr(), out.data_ptr(), t, m * n, n,
        beta, v_thresh, KB.stream_ptr(counts))
    KB.raise_on_error(err, "lif")
    KB.LAUNCHES["lif"] += 1
    return out
