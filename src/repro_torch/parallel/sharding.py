"""What one rank of a ``(data, model)`` mesh holds.

Twin of the parts of ``repro/parallel/sharding.py`` the executor and the
train launcher use, written as shapes and pieces instead of
PartitionSpecs:

* **serving state** (``batch_pspec``, ``cache_pspecs``): decode slots
  split over ``data`` in contiguous blocks (rank ``d`` holds slots ``[d *
  slots/D, (d+1) * slots/D)``), the spiking KV-head axis of the cache and
  of the page pool splits over ``model`` (each rank caches its own heads'
  trains), the cache length and the page axis never split (pages are
  global: any slot may read any page), and the pool is whole on every rank
  of a data group;
* **parameters** (``param_pspecs``): :func:`param_placement` -- on a
  data-parallel training mesh every leaf is whole on every rank; on a
  serving mesh each spiking linear that the model axis splits
  (:class:`repro_torch.distributed.backend.TPPlan`) has the quantised or
  programmed operands of the model cut :func:`repro_torch.convert.
  shard_params` gives (a float linear is held whole: the column scale is
  taken over the whole matrix before it is cut), a float stack's MoE
  experts are cut on their expert axis into contiguous blocks of ``E /
  model`` (the reference's ``shard_map`` in-spec ``P("model", None,
  None)``), and everything else is whole.  The port keeps no FSDP layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

# the matrix fields of a quantised ({"levels", "scale", "b"}) or programmed
# (AIMCDeviceState) spiking linear; "scale" and "b" are per output column
_MATRIX_FIELDS = frozenset({"levels", "eps", "nu", "levels_t"})
_COLUMN_FIELDS = frozenset({"scale", "b"})


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a rank holds a leaf, and which piece: the whole leaf
    (``part=None``), or block ``index`` of ``parts`` of a spiking linear
    cut by columns (``"col"``) or by input rows (``"row"``)."""

    device: torch.device
    part: Optional[str] = None  # "col", "row" or "experts"
    parts: int = 1
    index: int = 0

    @property
    def whole(self) -> bool:
        return self.part is None or self.parts == 1

    def piece(self, x: np.ndarray, field: Optional[str]) -> np.ndarray:
        """This rank's piece of ``x``, the leaf named ``field`` in the
        linear this placement covers (``None``: the linear is a float
        weight, held whole).  Matrix fields are cut on their output axis
        (``col``) or input axis (``row``), the per-column ``scale`` and
        ``b`` by ``col`` only; the clock, ``gdc_gain`` and ``img_inv`` stay
        whole, as :func:`repro_torch.convert.shard_params` cuts them.  A
        MoE leaf (``"experts"``) is cut on its expert axis (-3)."""
        if self.whole:
            return x
        if self.part == "experts":
            axis = -3
        elif field is None:
            return x
        elif field in _MATRIX_FIELDS:
            axis = -1 if self.part == "col" else -2
        elif field in _COLUMN_FIELDS and self.part == "col":
            axis = -1
        else:
            return x
        n = x.shape[axis] // self.parts
        index = [slice(None)] * x.ndim
        index[axis] = slice(self.index * n, (self.index + 1) * n)
        return x[tuple(index)]


def _spiking_linears(cfg):
    """``{(group, name): part}`` of a block's spiking linears."""
    from repro_torch.distributed.backend import TP_PARTS

    out = {("mixer", n): TP_PARTS[n] for n in ("wq", "wk", "wv", "wo")}
    if cfg.d_ff > 0 and not cfg.is_moe:
        out[("mlp", "wi")] = TP_PARTS["wi"]
        out[("mlp", "wo")] = TP_PARTS["wo"]
    return out


def model_cut(cfg, model: int) -> Dict[tuple, str]:
    """``{(group, name): part}`` of the block leaves a serving mesh of
    ``model`` ranks cuts: a spiking SSA stack's linears whose block part
    splits (``TPPlan``), a float stack's MoE experts (``"experts"``, which
    ``model`` must divide); nothing at ``model = 1``."""
    from repro_torch.distributed.backend import TPPlan
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    if model <= 1:
        return {}
    if T.spiking_decode_enabled(cfg):
        plan = TPPlan.from_config(cfg, model)
        return {k: part for k, part in _spiking_linears(cfg).items()
                if plan.splits(k[0])}
    if cfg.is_moe and not cfg.spiking:
        M.expert_block(cfg.num_experts, model)
        return {("moe", n): "experts" for n in ("wi", "wg", "wo")}
    return {}


def param_placement(cfg, mesh_shape, *, device, model_index: int = 0,
                    serving: bool = False) -> Dict[str, Any]:
    """A rank's :class:`Placement` of every parameter of ``cfg``'s LM
    stack, a tree of the parameters' structure (a spiking linear's
    placement covers its whole subtree: a float weight, ``{"levels",
    "scale", "b"}`` or a programmed state).  ``serving=False``: the
    data-parallel training mesh, every leaf whole (``model > 1`` raises:
    model-parallel training is not ported, ROADMAP A2(c)).  ``serving``:
    the ``model`` cut of rank ``model_index`` (:func:`model_cut`)."""
    from repro_torch.models import transformer as T

    data, model = mesh_shape
    if data < 1 or model < 1:
        raise ValueError(f"mesh shape {tuple(mesh_shape)} holds no rank")
    if model > 1 and not serving:
        raise NotImplementedError(
            f"a training mesh of model={model}: model-parallel training is "
            "not ported (ROADMAP A2(c)); the float reference backend has no "
            "sharded form")
    whole = Placement(torch.device(device))
    cut = model_cut(cfg, model)

    def block(shapes):
        out = {}
        for group, leaves in shapes.items():
            out[group] = {
                name: (Placement(whole.device, cut[(group, name)], model,
                                 model_index)
                       if (group, name) in cut else whole)
                for name in leaves}
        return out

    out: Dict[str, Any] = {}
    for key, sub in T._model_shapes(cfg).items():
        if key in ("periods", "remainder"):
            out[key] = {b: block(s) for b, s in sub.items()}
        else:
            out[key] = {n: whole for n in sub}
    return out


def placement_specs(placement) -> Dict[str, str]:
    """``{path: spec}`` of a placement tree (``"whole"`` or
    ``"<part>/<parts>"``), in JAX's key order: what a layout change
    reports."""
    out: Dict[str, str] = {}

    def walk(node, path):
        if isinstance(node, Placement):
            out[path] = ("whole" if node.whole
                         else f"{node.part}/{node.parts}")
            return
        for k in sorted(node):
            walk(node[k], f"{path}['{k}']")

    walk(placement, "")
    return out

def local_slots(slots: int, data: int) -> int:
    """Decode slots one rank holds: ``slots / data``; ``slots`` must split
    evenly (a rank's decode step computes exactly its own slots)."""
    if slots % data:
        raise ValueError(f"{slots} slots do not split over data={data} "
                         "ranks: use a multiple of the data axis")
    return slots // data


def slot_range(slots: int, data: int, index: int) -> range:
    """The global slots data rank ``index`` holds."""
    n = local_slots(slots, data)
    return range(index * n, (index + 1) * n)


def local_kv_heads(cfg, model: int) -> Optional[int]:
    """KV heads one rank caches of a spiking SSA stack: ``num_kv_heads /
    model`` where the heads split (``TPPlan``), all of them where they do
    not; ``None`` for any other stack (its caches are whole over
    ``model``)."""
    from repro_torch.distributed.backend import TPPlan
    from repro_torch.models import transformer as T

    if not T.spiking_decode_enabled(cfg):
        return None
    if TPPlan.from_config(cfg, model).heads:
        return cfg.num_kv_heads // model
    return cfg.num_kv_heads
