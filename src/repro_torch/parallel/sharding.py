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
* **serving parameters** (``param_placement(serving=True)``): each
  spiking linear that the model axis splits (:class:`repro_torch.
  distributed.backend.TPPlan`) has the quantised or programmed operands
  of the model cut :func:`repro_torch.convert.shard_params` gives (a float
  linear is held whole: the column scale is taken over the whole matrix
  before it is cut), a float stack's MoE experts are cut on their expert
  axis into contiguous blocks of ``E / model`` (the reference's
  ``shard_map`` in-spec ``P("model", None, None)``), and everything else
  is whole;
* **training parameters** (``param_placement(serving=False)``,
  :func:`train_cut`): the reference's ``RULES`` where the port cuts --
  an attention's ``heads``/``kv_heads`` over ``model`` (Q/K/V by columns,
  the out-projection by rows) where both head counts divide, else the
  attention whole; the MLP's ``ffn`` over ``model``; a float stack's
  ``experts`` over ``model`` and, with ``fsdp``, their ``expert_ffn``
  over ``data``.  Every other leaf is whole on every rank (the embedding
  and unembedding, norms, the router, SSD, RG-LRU, frontends, a spiking
  stack's experts); the reference's ZeRO-3 cut of the ``embed`` axis, its
  vocab-parallel embedding and its cut of SSD and RG-LRU are not ported
  (ROADMAP A2(d): they change memory, not values).  ``pure_dp``: every
  leaf whole.  :func:`make_pctx` is the matching
  :class:`repro_torch.models.moe.ParallelCtx`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as TR

# the matrix fields of a quantised ({"levels", "scale", "b"}) or programmed
# (AIMCDeviceState) spiking linear; "scale" and "b" are per output column
_MATRIX_FIELDS = frozenset({"levels", "eps", "nu", "levels_t"})
_COLUMN_FIELDS = frozenset({"scale", "b"})


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a rank holds a leaf, and which piece: the whole leaf
    (``part=None``), or block ``index`` of ``parts`` of a spiking linear
    cut by columns (``"col"``) or by input rows (``"row"``); or, on a
    training mesh, ``spec``: the mesh axis (``"data"``, ``"model"`` or
    ``None``) each axis of the leaf is cut over, as a PartitionSpec names
    them, for a rank at ``coords = (data index, model index)`` of a
    ``mesh_shape`` mesh."""

    device: torch.device
    part: Optional[str] = None  # "col", "row" or "experts"
    parts: int = 1
    index: int = 0
    spec: Tuple[Optional[str], ...] = ()
    mesh_shape: Tuple[int, int] = (1, 1)
    coords: Tuple[int, int] = (0, 0)

    def axis_size(self, axis: Optional[str]) -> int:
        return {"data": self.mesh_shape[0],
                "model": self.mesh_shape[1]}.get(axis, 1)

    @property
    def cut_over(self) -> Tuple[str, ...]:
        """The mesh axes a training cut splits this leaf over."""
        return tuple(a for a in self.spec if self.axis_size(a) > 1)

    @property
    def whole(self) -> bool:
        return (self.part is None or self.parts == 1) and not self.cut_over

    def piece(self, x: np.ndarray, field: Optional[str]) -> np.ndarray:
        """This rank's piece of ``x``, the leaf named ``field`` in the
        linear this placement covers (``None``: the linear is a float
        weight, held whole).  Matrix fields are cut on their output axis
        (``col``) or input axis (``row``), the per-column ``scale`` and
        ``b`` by ``col`` only; the clock, ``gdc_gain`` and ``img_inv`` stay
        whole, as :func:`repro_torch.convert.shard_params` cuts them.  A
        MoE leaf (``"experts"``) is cut on its expert axis (-3).  A
        training ``spec`` cuts each named axis into the rank's block (an
        int8 moment's ``"scale"``, one axis short of its leaf, by all but
        the last)."""
        if self.whole:
            return x
        if self.spec:
            spec = self.spec[:-1] if field == "scale" else self.spec
            index = [slice(None)] * x.ndim
            for ax, name in enumerate(spec):
                size = self.axis_size(name)
                if size > 1:
                    n = x.shape[ax] // size
                    i = self.coords[0 if name == "data" else 1]
                    index[ax] = slice(i * n, (i + 1) * n)
            return x[tuple(index)]
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


def _attention_cut(cfg, model: int) -> bool:
    """Whether a training mesh cuts the attention's heads: both head
    counts divide over ``model`` (:class:`TPPlan`'s rule)."""
    from repro_torch.distributed.backend import TPPlan

    return TPPlan.from_config(cfg, model).heads


def _mlp_width(cfg) -> int:
    """The dense MLP's ``ffn`` width (a MoE block's residual MLP:
    ``moe_dense_ff``); 0 without one."""
    if cfg.d_ff <= 0:
        return 0
    return cfg.moe_dense_ff if cfg.is_moe else cfg.d_ff


def train_cut(cfg, mesh_shape, *, fsdp: bool = True,
              pure_dp: bool = False) -> Dict[tuple, Tuple[Optional[str], ...]]:
    """``{(group, name): spec}`` of the block leaves a training mesh cuts
    (see the module), ``spec`` over one layer's axes (the stacked period
    axis comes first and is never cut).  Raises where the reference's
    expert-parallel dispatch cannot place the experts (``E`` or their
    ``d_ff`` not divisible)."""
    from repro_torch.models import moe as M

    data, model = mesh_shape
    if pure_dp or data * model == 1:
        return {}
    out: Dict[tuple, Tuple[Optional[str], ...]] = {}
    if model > 1 and _attention_cut(cfg, model):
        out.update({("mixer", "wq"): (None, "model", None),
                    ("mixer", "wk"): (None, "model", None),
                    ("mixer", "wv"): (None, "model", None),
                    ("mixer", "wo"): ("model", None, None)})
        if cfg.qkv_bias:
            out.update({("mixer", b): ("model", None)
                        for b in ("bq", "bk", "bv")})
    ff = 0 if (cfg.spiking and cfg.is_moe) else _mlp_width(cfg)
    if model > 1 and ff and ff % model == 0:
        out.update({("mlp", "wi"): (None, "model"),
                    ("mlp", "wg"): (None, "model"),
                    ("mlp", "wo"): ("model", None)})
    if cfg.is_moe and not cfg.spiking:
        if model > 1:
            M.expert_block(cfg.num_experts, model)
        f = "data" if (fsdp and data > 1) else None
        if f and cfg.d_ff % data:
            raise ValueError(f"{cfg.name}: the experts' d_ff {cfg.d_ff} does "
                             f"not split over data={data} (fsdp)")
        e = "model" if model > 1 else None
        out.update({("moe", "wi"): (e, None, f), ("moe", "wg"): (e, None, f),
                    ("moe", "wo"): (e, f, None)})
    return {k: v for k, v in out.items() if any(v)}


def param_placement(cfg, mesh_shape, *, device, model_index: int = 0,
                    serving: bool = False, data_index: int = 0,
                    fsdp: bool = True, pure_dp: bool = False
                    ) -> Dict[str, Any]:
    """A rank's :class:`Placement` of every parameter of ``cfg``'s LM
    stack, a tree of the parameters' structure (a spiking linear's
    placement covers its whole subtree: a float weight, ``{"levels",
    "scale", "b"}`` or a programmed state).  ``serving=False``: the
    training cut (:func:`train_cut`) of the rank at ``(data_index,
    model_index)``; ``serving``: the ``model`` cut of rank ``model_index``
    (:func:`model_cut`)."""
    from repro_torch.models import transformer as T

    data, model = mesh_shape
    if data < 1 or model < 1:
        raise ValueError(f"mesh shape {tuple(mesh_shape)} holds no rank")
    whole = Placement(torch.device(device))
    if not serving:
        tcut = train_cut(cfg, mesh_shape, fsdp=fsdp, pure_dp=pure_dp)

        def tblock(shapes, lead):
            return {group: {name: (Placement(
                whole.device, spec=lead + tcut[(group, name)],
                mesh_shape=(data, model), coords=(data_index, model_index))
                if (group, name) in tcut else whole)
                for name in leaves} for group, leaves in shapes.items()}

        out: Dict[str, Any] = {}
        for key, sub in T._model_shapes(cfg).items():
            if key in ("periods", "remainder"):
                lead = (None,) if key == "periods" else ()
                out[key] = {b: tblock(s, lead) for b, s in sub.items()}
            else:
                out[key] = {n: whole for n in sub}
        return out
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
            out[path] = ("whole" if node.whole else spec_string(node.spec)
                         if node.spec else f"{node.part}/{node.parts}")
            return
        for k in sorted(node):
            walk(node[k], f"{path}['{k}']")

    walk(placement, "")
    return out

def leaf_placements(tree, placement) -> list:
    """The :class:`Placement` of each leaf of ``tree`` (a parameter tree,
    or one of its moment trees) in :func:`repro_torch.tree.flatten`'s
    order; ``placement`` is a prefix of ``tree``."""
    out: list = []

    def walk(t, p):
        if isinstance(p, Placement):
            out.extend([p] * len(TR.flatten(t)[0]))
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, p[k])
        elif t is not None:
            raise TypeError(f"no placement for a {type(t).__name__} leaf")

    walk(tree, placement)
    return out


def leaf_cuts(tree, placement) -> list:
    """``(axes, last_axis)`` of each leaf of ``tree``
    (:func:`leaf_placements`): the mesh axes it is cut over, and the one
    its last axis is cut over (``None``) -- what the optimizer reads."""
    out = []
    for p in leaf_placements(tree, placement):
        last = p.spec[-1] if p.spec and p.axis_size(p.spec[-1]) > 1 else None
        out.append((p.cut_over, last))
    return out


def spec_string(spec) -> str:
    """A training spec as the reference prints a PartitionSpec's entries,
    trailing ``None`` trimmed: ``"(None, 'model')"``."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return "(" + ", ".join(repr(a) for a in spec) + ")"


def make_pctx(mesh, parallel):
    """The training :class:`repro_torch.models.moe.ParallelCtx` of a rank
    (the twin of the reference's ``make_pctx``): ``mesh`` ``None`` or of
    one rank -- one device; else the rank's batch rows over ``data``
    (``pure_dp``: over every rank), the model group cutting what
    :func:`train_cut` cuts, MoE tokens split by sequence over ``model``
    with ``seq_shard``, the experts' ``d_ff`` over ``data`` with
    ``fsdp``."""
    from repro_torch.models.moe import ParallelCtx

    if mesh is None or mesh.data * mesh.model == 1:
        return ParallelCtx()
    pure = bool(getattr(parallel, "pure_dp", False))
    return ParallelCtx(mesh=mesh, train=True, pure_dp=pure,
                       fsdp=bool(parallel.fsdp) and not pure and mesh.data > 1,
                       seq_shard=bool(parallel.seq_shard) and not pure)


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
