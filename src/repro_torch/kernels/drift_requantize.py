"""K6 launcher: the drift fold of programmed PCM state, every leaf of a
tree in one launch (``csrc/drift_requantize.cu``).

Replaces ``repro/kernels/aimc_matmul.py:drift_requantize_kernel``.  A leaf
is a :class:`FoldLeaf`.  :func:`drift_fold_kernel` returns each leaf's
int8 image; :func:`drift_abs_sums_kernel` writes no image and returns the
calibration read of GDC, each matrix's sum of ``|image|``.  Up to
:data:`MAX_LEAVES` leaves go in one launch (their descriptors in the
kernel's parameters); a longer list is launched in chunks.  On CPU tensors
each wrapper runs its plain version
(:func:`repro_torch.kernels.ref.drift_fold_leaves_ref`,
:func:`~repro_torch.kernels.ref.drift_abs_sums_ref`); on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels import ref as KREF

Tensor = torch.Tensor
MAX_LEAVES = 32  # csrc/drift_requantize.cu:kMaxLeaves


class FoldLeaf(NamedTuple):
    """One programmed leaf: ``levels``/``eps``/``nu [..., d_in, d_out]``
    f32, ``t_seconds [...]`` f32 (``None``: t = 0) and ``img_inv [...]``
    f32, ``1 / image gain`` per matrix."""
    levels: Tensor
    eps: Tensor
    nu: Tensor
    t_seconds: Optional[Tensor]
    img_inv: Tensor


class _Leaf(ctypes.Structure):  # csrc/drift_requantize.cu:XpkDriftLeaf
    _fields_ = [("levels", ctypes.c_void_p), ("eps", ctypes.c_void_p),
                ("nu", ctypes.c_void_p), ("t_sec", ctypes.c_void_p),
                ("img_inv", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("sums", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("n_mat", ctypes.c_int), ("pad", ctypes.c_int)]


def _lib():
    fn = KB.load("drift_requantize").launch_drift_fold
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _operands(leaf: FoldLeaf, dev: int):
    """A leaf's operands checked (shapes; all on ``cuda:dev``) and
    conformed (f32, contiguous), and its matrix width and count."""
    lv, eps, nu, t, inv = leaf
    shape = lv.shape
    lead = shape[:-2]
    if (len(shape) < 2 or eps.shape != shape or nu.shape != shape
            or inv.shape != lead or (t is not None and t.shape != lead)):
        raise ValueError(
            f"drift_fold: a leaf of levels {tuple(shape)}, eps "
            f"{tuple(eps.shape)}, nu {tuple(nu.shape)}, img_inv "
            f"{tuple(inv.shape)} and t "
            f"{None if t is None else tuple(t.shape)} is not [..., d_in, "
            "d_out] with one time and gain a leading index")
    ops = (lv, eps, nu, t, inv)
    if any(x is not None and x.get_device() != dev for x in ops):
        raise ValueError(f"drift_fold: a leaf's operands are not all on "
                         f"cuda:{dev}")
    return ([None if x is None else KB.conform(x, torch.float32)
             for x in ops], shape[-2] * shape[-1], math.prod(lead))


def _launch(leaves: Sequence[FoldLeaf], t0: float,
            sums: Optional[Tensor]) -> Optional[List[Tensor]]:
    """Check, conform and launch; images unless ``sums`` (int64, zero, one
    entry a matrix of every leaf in order) takes the calibration read."""
    outs = None if sums is not None else []
    keep = []  # conformed copies live until every launch is issued
    descs = (_Leaf * min(len(leaves), MAX_LEAVES))()
    dev = leaves[0].levels.get_device()
    if dev < 0:
        raise ValueError("drift_fold: the leaves are not on a CUDA device")
    stream = KB.stream_ptr(leaves[0].levels)
    off, k = 0, 0
    for i, leaf in enumerate(leaves):
        ops, n, n_mat = _operands(leaf, dev)
        keep.append(ops)
        d = descs[k]
        d.levels, d.eps, d.nu = ops[0].data_ptr(), ops[1].data_ptr(), \
            ops[2].data_ptr()
        d.t_sec = 0 if ops[3] is None else ops[3].data_ptr()
        d.img_inv = ops[4].data_ptr()
        if outs is not None:
            out = torch.empty(leaf.levels.shape, dtype=torch.int8,
                              device=ops[0].device)
            outs.append(out)
            d.out = out.data_ptr()
        else:
            d.sums = sums.data_ptr() + 8 * off
        d.n, d.n_mat = n, n_mat
        off += n_mat
        k += 1
        if k == MAX_LEAVES or i == len(leaves) - 1:
            err = _lib()(ctypes.addressof(descs), k, t0, stream)
            KB.raise_on_error(err, "drift_fold")
            KB.LAUNCHES["drift_requantize"] += 1
            k = 0
    return outs


def drift_fold_kernel(leaves: Sequence[FoldLeaf], *, t0: float
                      ) -> List[Tensor]:
    """Each leaf's int8 image ``clip(rint((levels + eps) * (max(t, t0) /
    t0) ** -nu * rint(1 / img_inv)), -127, 127)`` ``[..., d_in, d_out]``,
    one launch for every :data:`MAX_LEAVES` leaves."""
    if not leaves:
        return []
    if not leaves[0].levels.is_cuda:
        return KREF.drift_fold_leaves_ref(leaves, t0=t0)
    return _launch(leaves, t0, None)


def drift_abs_sums_kernel(leaves: Sequence[FoldLeaf], *, t0: float) -> Tensor:
    """The calibration read of GDC: each matrix's sum of ``|image|`` (the
    images of :func:`drift_fold_kernel`, not written), int64 over every
    matrix of every leaf in order (a leaf's leading axes row-major)."""
    if not leaves:
        return torch.zeros(0, dtype=torch.int64)
    if not leaves[0].levels.is_cuda:
        return KREF.drift_abs_sums_ref(leaves, t0=t0)
    total = sum(math.prod(leaf.levels.shape[:-2]) for leaf in leaves)
    sums = torch.zeros(total, dtype=torch.int64,
                       device=leaves[0].levels.device)
    _launch(leaves, t0, sums)
    return sums
