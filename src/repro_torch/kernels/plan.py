"""The decode-kernel surface: KVView / AttnSpec / DecodePlan.

Twins of ``repro.kernels.plan``.  :class:`KVView` is a dense slot cache
or a block-paged pool addressed through a per-slot page table.
``build_decode_plan(cfg, backend, layout=, kernel="auto", page_len=)``
resolves to the fused layer kernel wherever the config and backend support
it; the scheduler builds one plan per lifetime.
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
    hd]`` (fused path), ``page_table`` ``None``, and optionally ``pos
    [B]`` int32, each slot's live length (its rows at and past it are
    zero, so a kernel need not read them).  Paged: page pools ``[P, T, KV,
    page_len, hd]`` and ``page_table [B, MP]`` int32 (page 0 is the
    permanently zero null page), and optionally ``pos [B]`` int32, each
    slot's write position this step (the unfused path attends after the
    scatter: rows up to and including it are live, later ones zero)."""

    k: Tensor
    v: Tensor
    page_table: Optional[Tensor] = None
    pos: Optional[Tensor] = None

    @property
    def paged(self) -> bool:
        return self.page_table is not None

    @classmethod
    def dense(cls, k: Tensor, v: Tensor, pos: Optional[Tensor] = None
              ) -> "KVView":
        return cls(k=k, v=v, pos=pos)

    @classmethod
    def from_pool(cls, kpool: Tensor, vpool: Tensor, page_table: Tensor,
                  pos: Optional[Tensor] = None) -> "KVView":
        return cls(k=kpool, v=vpool, page_table=page_table, pos=pos)


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

    layout: str = "dense"  # "dense" | "paged"
    kernel: str = "unfused"  # "fused" | "unfused"
    page_len: int = 0  # tokens per KV page (paged layout)
    reasons: Tuple[str, ...] = ()

    @property
    def fused(self) -> bool:
        return self.kernel == "fused"

    def describe(self) -> str:
        geo = f", page_len={self.page_len}" if self.layout == "paged" else ""
        why = f" ({'; '.join(self.reasons)})" if self.reasons else ""
        return f"DecodePlan({self.layout}, {self.kernel}{geo}){why}"


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
    return True, "fused megakernel supported"


def build_decode_plan(cfg, backend=None, *, layout: str = "dense",
                      kernel: str = "auto", page_len: int = 8) -> DecodePlan:
    """``kernel``: ``"auto"`` picks the fused layer kernel where supported,
    ``"fused"`` demands it (``ValueError`` otherwise), ``"unfused"`` forces
    the per-primitive path.  ``layout`` mirrors the scheduler's ``paged=``;
    ``page_len`` only matters for the paged layout."""
    if layout not in ("dense", "paged"):
        raise ValueError(f"layout must be dense|paged, got {layout!r}")
    if kernel not in ("auto", "fused", "unfused"):
        raise ValueError(f"kernel must be auto|fused|unfused, got {kernel!r}")
    ok, why = _fused_supported(cfg, backend)
    if kernel == "fused" and not ok:
        raise ValueError(f"decode kernel 'fused' unsupported: {why}")
    resolved = "fused" if (kernel == "fused" or (kernel == "auto" and ok)) \
        else "unfused"
    return DecodePlan(layout=layout, kernel=resolved,
                      page_len=page_len if layout == "paged" else 0,
                      reasons=(why,))
