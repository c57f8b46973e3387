"""K4 launcher: the LIF neuron over the spike-time axis (``csrc/lif.cu``).

Replaces ``repro/kernels/lif.py:lif_kernel``.  On a CPU tensor the wrapper
runs the plain version (:func:`repro_torch.kernels.ref.lif_ref`); on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels import ref as KREF

Tensor = torch.Tensor
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


def _lib():
    fn = KB.load("lif").launch_lif
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _I, _L, _F, _F, _P]
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
