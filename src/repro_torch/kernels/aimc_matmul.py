"""K1 launcher: the AIMC spiking linear (``csrc/aimc_matmul.cu``).

Replaces ``repro/kernels/aimc_matmul.py:aimc_spiking_linear_kernel``.  On
a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.aimc_spiking_linear_ref`); on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels import ref as KREF

Tensor = torch.Tensor
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    fn = KB.load("aimc_matmul").launch_aimc_spiking_linear
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P]
        fn.restype = ctypes.c_int
    return fn


def aimc_spiking_linear_kernel(spikes: Tensor, w_levels: Tensor,
                               scale: Tensor, bias: Optional[Tensor] = None,
                               *, beta: float = 0.5, v_thresh: float = 1.0
                               ) -> Tensor:
    """``spikes [T,M,d_in]`` f32 (integer-valued), ``w_levels [d_in,d_out]``
    int8, ``scale``/``bias [d_out]`` f32 -> uint8 ``[T,M,d_out]``."""
    if not spikes.is_cuda:
        return KREF.aimc_spiking_linear_ref(spikes, w_levels, scale, bias,
                                            beta=beta, v_thresh=v_thresh)
    t, m, d_in = spikes.shape
    d_out = w_levels.shape[1]
    if t > 8:
        raise ValueError(f"aimc_spiking_linear: T={t} > 8 timesteps")
    if bias is None:
        bias = torch.zeros(d_out, dtype=torch.float32, device=spikes.device)
    KB.check_cuda(spikes, torch.float32, (t, m, d_in), "spikes")
    KB.check_cuda(w_levels, torch.int8, (d_in, d_out), "w_levels")
    KB.check_cuda(scale, torch.float32, (d_out,), "scale")
    KB.check_cuda(bias, torch.float32, (d_out,), "bias")
    out = torch.empty((t, m, d_out), dtype=torch.uint8, device=spikes.device)
    fn = _lib()
    err = fn(spikes.data_ptr(), w_levels.data_ptr(), scale.data_ptr(),
             bias.data_ptr(), out.data_ptr(), t, m, d_in, d_out, beta,
             v_thresh, KB.stream_ptr(spikes))
    KB.raise_on_error(err, "aimc_spiking_linear")
    KB.LAUNCHES["aimc_spiking_linear"] += 1
    return out
