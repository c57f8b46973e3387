"""K1 and K5 launchers: the AIMC spiking linear and the crossbar counts
alone (``csrc/aimc_matmul.cu``).

Replace ``repro/kernels/aimc_matmul.py:aimc_spiking_linear_kernel`` and
``aimc_matmul_counts_kernel``.  On a CPU tensor a wrapper runs the plain
version (:func:`repro_torch.kernels.ref.aimc_spiking_linear_ref`,
:func:`~repro_torch.kernels.ref.aimc_counts_ref`); on a CUDA tensor it
launches the kernel or raises.  :func:`launch_plan` picks the kernel's
regime from the shape: the int8 tensor-core GEMM at many rows, the split
of ``d_in`` across warps and blocks at few.  Spikes must be integers in
``[-128, 127]`` (the kernel traps on any other value).

A wrapper caches the zero bias it passes for ``bias=None`` and the int32
scratch of the split regime.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels import ref as KREF

Tensor = torch.Tensor
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

MMA_MIN_ROWS = 64  # T * M from which the tensor-core regime runs
# the split regime's plan: csrc/aimc_matmul.cu refuses a plan past its
# static buffers (kSplitAcc, kSplitXs, kThreads)
_SPLIT_ACC = 64  # int32 counts a thread keeps: T*M x columns
_SPLIT_XS = 8192  # int32 spikes a block stages
_SPLIT_MIN_BLOCKS = 64  # enough blocks to stream the weights from all SMs
_SPLIT_MAX_CHAIN = 8  # weight rows a thread takes one after another
_THREADS = 256

_ZERO_BIAS: Dict[Tuple[int, torch.device], Tensor] = {}
_SCRATCH: Dict[Tuple[torch.device, int], Tensor] = {}


class LaunchPlan(NamedTuple):
    """``regime`` ``"mma"`` or ``"split"``; ``split`` the kernel's four plan
    numbers: zeros for ``"mma"`` (its grid follows from the shape); for
    ``"split"`` (columns a thread, column groups a block, weight rows a
    thread, blocks along ``d_in``), from which the launcher sizes its
    grid."""
    regime: str
    split: Tuple[int, int, int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def launch_plan(t: int, m: int, d_in: int, d_out: int) -> LaunchPlan:
    """The kernel's regime for spikes ``[t, m, d_in]`` and levels ``[d_in,
    d_out]`` (``t, m, d_out >= 1``).

    ``t * m >= 64``: the int8 GEMM on the tensor cores.  Below: ``d_in``
    split so that about 64 blocks stream the weights, each thread taking
    the widest vector of columns (16 down to 1) that divides ``d_out`` and
    keeps ``t * m * columns <= 64`` counts in registers."""
    tm = t * m
    if tm >= MMA_MIN_ROWS:
        return LaunchPlan("mma", (0, 0, 0, 0))
    cpt = 16
    while cpt > 1 and (cpt * tm > _SPLIT_ACC or d_out % cpt):
        cpt //= 2
    groups = _cdiv(d_out, cpt)
    ncgb = 32 if groups > 16 else (16 if groups > 8 else 8)
    ncb = _cdiv(groups, ncgb)
    slots = _THREADS // ncgb
    chain = _SPLIT_MAX_CHAIN
    while chain > 1 and (slots * chain * tm > _SPLIT_XS or ncb * _cdiv(
            d_in, slots * chain) < _SPLIT_MIN_BLOCKS):
        chain //= 2
    ksplit = max(1, _cdiv(d_in, slots * chain))
    return LaunchPlan("split", (cpt, ncgb, chain, ksplit))


def _lib(name: str = "launch_aimc_spiking_linear"):
    fn = getattr(KB.load("aimc_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F]
                       if name == "launch_aimc_spiking_linear"
                       else [_P, _P, _P, _I, _I, _I, _I]) + [_I] * 5 + [_P, _P]
        fn.restype = ctypes.c_int
    return fn


def _plan_args(plan: LaunchPlan, device: torch.device, stream: int,
               sums: int, d_out: int) -> Tuple[int, ...]:
    """The launcher's trailing arguments: regime, split, scratch (a
    per-device, per-stream int32 buffer of ``sums`` counts and an arrival
    counter a column block, at most ``d_out``, which the kernel leaves
    zero) and stream."""
    scratch = 0
    if plan.regime == "split" and plan.split[3] > 1:
        need = sums + d_out
        key = (device, stream)
        buf = _SCRATCH.get(key)
        if buf is None or buf.numel() < need:
            buf = torch.zeros(max(need, 1 << 16), dtype=torch.int32,
                              device=device)
            _SCRATCH[key] = buf
        scratch = buf.data_ptr()
    return (0 if plan.regime == "mma" else 1, *plan.split, scratch, stream)


def _check_operands(spikes: Tensor, w_levels: Tensor) -> Tuple[int, ...]:
    """``spikes [T,M,d_in]`` f32 and ``w_levels [d_in,d_out]`` int8, both
    contiguous on the card, the levels 16-byte aligned (the kernels load
    weight rows as vectors); returns ``(T, M, d_in, d_out)``."""
    t, m, d_in = spikes.shape
    d_out = w_levels.shape[-1]
    KB.check_cuda(spikes, torch.float32, (t, m, d_in), "spikes")
    KB.check_cuda(w_levels, torch.int8, (d_in, d_out), "w_levels")
    if w_levels.data_ptr() % 16:
        raise ValueError("w_levels: expected a 16-byte aligned tensor")
    return t, m, d_in, d_out


def _zero_bias(d_out: int, device: torch.device) -> Tensor:
    key = (d_out, device)
    z = _ZERO_BIAS.get(key)
    if z is None:
        z = _ZERO_BIAS[key] = torch.zeros(d_out, dtype=torch.float32,
                                          device=device)
    return z


def aimc_spiking_linear_kernel(spikes: Tensor, w_levels: Tensor,
                               scale: Tensor, bias: Optional[Tensor] = None,
                               *, beta: float = 0.5, v_thresh: float = 1.0
                               ) -> Tensor:
    """``spikes [T,M,d_in]`` f32 (integers in [-128, 127]), ``w_levels
    [d_in,d_out]`` int8, ``scale``/``bias [d_out]`` f32 -> uint8
    ``[T,M,d_out]``."""
    if not spikes.is_cuda:
        return KREF.aimc_spiking_linear_ref(spikes, w_levels, scale, bias,
                                            beta=beta, v_thresh=v_thresh)
    t, m, d_in, d_out = _check_operands(spikes, w_levels)
    if bias is None:
        bias = _zero_bias(d_out, spikes.device)
    KB.check_cuda(scale, torch.float32, (d_out,), "scale")
    KB.check_cuda(bias, torch.float32, (d_out,), "bias")
    out = torch.empty((t, m, d_out), dtype=torch.uint8, device=spikes.device)
    if out.numel() == 0:
        return out
    err = _lib()(
        spikes.data_ptr(), w_levels.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), t, m, d_in, d_out, beta, v_thresh,
        *_plan_args(launch_plan(t, m, d_in, d_out), spikes.device,
                    KB.stream_ptr(spikes), out.numel(), d_out))
    KB.raise_on_error(err, "aimc_spiking_linear")
    KB.LAUNCHES["aimc_spiking_linear"] += 1
    return out


def aimc_matmul_counts_kernel(spikes: Tensor, w_levels: Tensor) -> Tensor:
    """``spikes [T,M,d_in]`` f32 (integers in [-128, 127]), ``w_levels
    [d_in,d_out]`` int8 -> the integer crossbar counts as f32
    ``[T,M,d_out]`` (no scale, bias or LIF): the shard-local half of a
    row-parallel spiking linear."""
    if not spikes.is_cuda:
        return KREF.aimc_counts_ref(spikes, w_levels)
    t, m, d_in, d_out = _check_operands(spikes, w_levels)
    out = torch.empty((t, m, d_out), dtype=torch.float32, device=spikes.device)
    if out.numel() == 0:
        return out
    err = _lib("launch_aimc_matmul_counts")(
        spikes.data_ptr(), w_levels.data_ptr(), out.data_ptr(), t, m, d_in,
        d_out, *_plan_args(launch_plan(t, m, d_in, d_out), spikes.device,
                           KB.stream_ptr(spikes), out.numel(), d_out))
    KB.raise_on_error(err, "aimc_matmul_counts")
    KB.LAUNCHES["aimc_matmul_counts"] += 1
    return out
