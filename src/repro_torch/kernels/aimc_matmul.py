"""K1 and K5 launchers: the AIMC spiking linear and the crossbar counts
alone (``csrc/aimc_matmul.cu``).

Replace ``repro/kernels/aimc_matmul.py:aimc_spiking_linear_kernel`` and
``aimc_matmul_counts_kernel``.  On a CPU tensor a wrapper runs the plain
version (:func:`repro_torch.kernels.ref.aimc_spiking_linear_ref`,
:func:`~repro_torch.kernels.ref.aimc_counts_ref`); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels import ref as KREF

Tensor = torch.Tensor
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib(name: str = "launch_aimc_spiking_linear"):
    fn = getattr(KB.load("aimc_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P]
                       if name == "launch_aimc_spiking_linear"
                       else [_P, _P, _P, _I, _I, _I, _I, _P])
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
    if t == 0 or m == 0:
        return out
    fn = _lib()
    err = fn(spikes.data_ptr(), w_levels.data_ptr(), scale.data_ptr(),
             bias.data_ptr(), out.data_ptr(), t, m, d_in, d_out, beta,
             v_thresh, KB.stream_ptr(spikes))
    KB.raise_on_error(err, "aimc_spiking_linear")
    KB.LAUNCHES["aimc_spiking_linear"] += 1
    return out


def aimc_matmul_counts_kernel(spikes: Tensor, w_levels: Tensor) -> Tensor:
    """``spikes [T,M,d_in]`` f32 (integer-valued), ``w_levels [d_in,d_out]``
    int8 -> the integer crossbar counts as f32 ``[T,M,d_out]`` (no scale,
    bias or LIF): the shard-local half of a row-parallel spiking linear."""
    if not spikes.is_cuda:
        return KREF.aimc_counts_ref(spikes, w_levels)
    t, m, d_in = spikes.shape
    d_out = w_levels.shape[1]
    if t > 8:
        raise ValueError(f"aimc_matmul_counts: T={t} > 8 timesteps")
    KB.check_cuda(spikes, torch.float32, (t, m, d_in), "spikes")
    KB.check_cuda(w_levels, torch.int8, (d_in, d_out), "w_levels")
    out = torch.empty((t, m, d_out), dtype=torch.float32, device=spikes.device)
    if t == 0 or m == 0:
        return out
    err = _lib("launch_aimc_matmul_counts")(
        spikes.data_ptr(), w_levels.data_ptr(), out.data_ptr(), t, m, d_in,
        d_out, KB.stream_ptr(spikes))
    KB.raise_on_error(err, "aimc_matmul_counts")
    KB.LAUNCHES["aimc_matmul_counts"] += 1
    return out
