"""K6 launcher: the drift fold of programmed PCM state
(``csrc/drift_requantize.cu``).

Replaces ``repro/kernels/aimc_matmul.py:drift_requantize_kernel``.  On a
CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.drift_requantize_ref`); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels import ref as KREF

Tensor = torch.Tensor
_P, _L, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float


def _lib():
    fn = KB.load("drift_requantize").launch_drift_requantize
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _L, _L, _F, _P]
        fn.restype = ctypes.c_int
    return fn


def drift_requantize_kernel(levels: Tensor, eps: Tensor, nu: Tensor,
                            t_seconds: Tensor, img_gain: Tensor, *,
                            t0: float) -> Tensor:
    """``levels``/``eps``/``nu [..., d_in, d_out]`` f32, ``t_seconds`` and
    ``img_gain`` f32 over the leading axes ``[...]`` -> the int8 image
    ``clip(round((levels + eps) * (max(t, t0) / t0) ** -nu * img_gain),
    -127, 127)``, one launch for every leading matrix."""
    if not levels.is_cuda:
        return KREF.drift_requantize_ref(levels, eps, nu, t_seconds, t0=t0,
                                         img_gain=img_gain)
    shape = tuple(levels.shape)
    if len(shape) < 2:
        raise ValueError(f"drift_requantize: levels of shape {shape} is not "
                         "[..., d_in, d_out]")
    lead = shape[:-2]
    KB.check_cuda(levels, torch.float32, shape, "levels")
    KB.check_cuda(eps, torch.float32, shape, "eps")
    KB.check_cuda(nu, torch.float32, shape, "nu")
    KB.check_cuda(t_seconds, torch.float32, lead, "t_seconds")
    KB.check_cuda(img_gain, torch.float32, lead, "img_gain")
    out = torch.empty(shape, dtype=torch.int8, device=levels.device)
    n = shape[-2] * shape[-1]
    n_mat = levels.numel() // n if n else 0
    if n == 0 or n_mat == 0:
        return out
    err = _lib()(levels.data_ptr(), eps.data_ptr(), nu.data_ptr(),
                 t_seconds.data_ptr(), img_gain.data_ptr(), out.data_ptr(),
                 n, n_mat, t0, KB.stream_ptr(levels))
    KB.raise_on_error(err, "drift_requantize")
    KB.LAUNCHES["drift_requantize"] += 1
    return out
