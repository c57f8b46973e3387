"""The decode-kernel surface: KVView / AttnSpec / DecodePlan.

Twins of ``repro.kernels.plan``.  :class:`KVView` keeps the reference's
type with its ``page_table`` field, but this slice serves the dense layout
only: a paged view raises in the backends.  ``build_decode_plan(cfg,
backend, kernel="auto")`` resolves to the fused layer kernel wherever the
config and backend support it; the scheduler builds one plan per lifetime.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class KVView:
    """What a decode step attends over.  Dense: per-slot spike caches
    ``[T, B, H, L, hd]`` (unfused path, GQA-repeated) or ``[B, T, L, KV,
    hd]`` (fused path), ``page_table`` ``None``."""

    k: Tensor
    v: Tensor
    page_table: Optional[Tensor] = None

    @property
    def paged(self) -> bool:
        return self.page_table is not None

    @classmethod
    def dense(cls, k: Tensor, v: Tensor) -> "KVView":
        return cls(k=k, v=v)


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Static decode-attention geometry: ``i_max`` the logical cache
    capacity (the output comparator range), ``h0`` the first global head
    of this caller."""

    i_max: int
    h0: Any = 0


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """A resolved kernel strategy for one serving stack."""

    kernel: str = "unfused"  # "fused" | "unfused"
    reasons: Tuple[str, ...] = ()

    @property
    def fused(self) -> bool:
        return self.kernel == "fused"

    def describe(self) -> str:
        why = f" ({'; '.join(self.reasons)})" if self.reasons else ""
        return f"DecodePlan(dense, {self.kernel}){why}"


def _fused_supported(cfg, backend) -> Tuple[bool, str]:
    if not (getattr(cfg, "spiking", False)
            and getattr(cfg, "attention_kind", "") == "ssa"):
        return False, "fused decode needs a spiking SSA config"
    if not all(m in ("attn", "local") for m in cfg.block_pattern):
        return False, f"non-attention mixers in pattern {cfg.block_pattern}"
    if getattr(cfg, "is_moe", False):
        return False, "MoE FFN tails decode on the rate interface"
    if backend is None or not callable(
            getattr(backend, "decode_layer_fused", None)):
        name = getattr(backend, "name", backend)
        return False, f"backend {name!r} has no decode_layer_fused"
    return True, "fused layer kernel supported"


def build_decode_plan(cfg, backend=None, *, kernel: str = "auto") -> DecodePlan:
    """``kernel``: ``"auto"`` picks the fused layer kernel where supported,
    ``"fused"`` demands it (``ValueError`` otherwise), ``"unfused"`` forces
    the per-primitive path.  Only the dense layout is ported."""
    if kernel not in ("auto", "fused", "unfused"):
        raise ValueError(f"kernel must be auto|fused|unfused, got {kernel!r}")
    ok, why = _fused_supported(cfg, backend)
    if kernel == "fused" and not ok:
        raise ValueError(f"decode kernel 'fused' unsupported: {why}")
    resolved = "fused" if (kernel == "fused" or (kernel == "auto" and ok)) \
        else "unfused"
    return DecodePlan(kernel=resolved, reasons=(why,))
