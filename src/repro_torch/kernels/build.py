"""Build and load the Hopper kernels: ``nvcc`` by hand, bound with ctypes.

Each ``csrc/*.cu`` compiles to its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for ``sm_90a``,
with ``-fmad=false`` so no ``a * b + c`` contracts into an FMA (the
bit-exactness contract rounds the product and the sum separately).  The
sources build in parallel, one ``nvcc`` each, at first use, into
``kernels/_build/`` (listed in ``.gitignore``); a library's file name
carries a hash of its sources and flags, so an edited source never loads a
stale build.  Nothing here runs at import time.

Every wrapper counts its launches in :data:`LAUNCHES` (one per kernel
launch, nowhere else), so a run can show that its path went through the
kernels; K8's keyed entry counts apart from its given-draws entry
(``ssa_attention_keyed``), so a run shows which one its path took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("aimc_matmul", "ssa_attention", "decode_fused", "lif",
           "drift_requantize")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# shared memory one block may use on the H100: 227 KB, static and dynamic
SMEM_PER_BLOCK = 232448

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {
    "aimc_spiking_linear": 0, "ssa_decode": 0, "fused_decode_layer": 0,
    "ssa_decode_paged": 0, "fused_decode_layer_paged": 0,
    "ssa_attention": 0, "ssa_attention_keyed": 0, "lif": 0,
    "drift_requantize": 0, "aimc_matmul_counts": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}  # source -> nvcc's stderr (ptxas resources)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[List[str]] = None) -> float:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together.  Returns the
    wall seconds spent; raises with the compiler's output on failure."""
    t0 = time.perf_counter()
    todo = [n for n in (names or SOURCES) if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    errors = []
    for n, (tmp, p) in procs.items():
        out, err = p.communicate()
        BUILD_LOG[n] = (out + err).strip()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}{err}")
            continue
        os.replace(tmp, _lib_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(t: torch.Tensor, dtype: torch.dtype, shape, what: str) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype/shape."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def conform(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous tensor of ``dtype``: itself where it is one (a
    conversion the caller does not need costs the host a dispatch)."""
    if t.dtype != dtype:
        t = t.to(dtype)
    return t if t.is_contiguous() else t.contiguous()


def raise_on_error(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
