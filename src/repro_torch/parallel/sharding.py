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
  :func:`train_specs`): the reference's ``RULES`` and ``spec_for`` leaf by
  leaf, over each leaf's logical axes (:func:`param_axes`, the reference's
  ``model_schema``): a dimension takes the first candidate whose mesh axis
  is unused by the leaf's earlier dimensions and divides it, else stays
  whole.  So with ``fsdp`` every leaf's ``embed`` axis is cut over
  ``data`` (ZeRO-3: attention, MLP, norms, the router, SSD, RG-LRU, the
  frontend projection, the embedding and the unembedding), and over
  ``model`` the ``vocab`` axis (the embedding and unembedding), the
  attention's ``heads`` and ``kv_heads`` each where it divides (the query
  heads cut beside whole KV heads where only they divide), ``ffn``, a
  float stack's ``experts`` (their ``expert_ffn`` over ``data`` with
  ``fsdp``), SSD's ``ssm_inner`` and ``ssm_heads`` and RG-LRU's ``lru``.
  One leaf may be cut over both axes (``table [vocab -> model, embed ->
  data]``).  ``pure_dp``: every leaf whole.  :func:`make_pctx` is the
  matching :class:`repro_torch.models.moe.ParallelCtx`.
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


# a parameter's logical axis -> its candidate mesh axes, in order: the
# reference's ``RULES`` for parameters on a ``(data, model)`` mesh (each
# of its candidates there is one mesh axis; an axis not named here, such
# as ``head_dim`` or ``layers``, is never cut)
RULES: Dict[str, Tuple[str, ...]] = {
    "vocab": ("model",), "heads": ("model",), "kv_heads": ("model",),
    "ffn": ("model",), "experts": ("model",), "expert_ffn": ("data",),
    "ssm_inner": ("model",), "ssm_heads": ("model",),
    "ssm_conv": ("model",), "lru": ("model",), "embed": ("data",),
}
_FSDP_GATED = frozenset({"embed", "expert_ffn"})


def spec_for(axes, shape, sizes: Dict[str, int], *, fsdp: bool = True,
             overrides=None) -> Tuple[Optional[str], ...]:
    """The reference's ``spec_for``: each dimension takes the first
    candidate of its logical axis (``RULES``) that is in ``sizes``, unused
    by the tensor's earlier dimensions and divides it, else stays whole
    (``None``); ``embed`` and ``expert_ffn`` only with ``fsdp``."""
    rules = dict(RULES, **(overrides or {}))
    used: set = set()
    out = []
    for name, dim in zip(axes, shape):
        picked = None
        if name is not None and not (name in _FSDP_GATED and not fsdp):
            for a in rules.get(name, ()):
                if a not in used and sizes.get(a, 1) > 1 \
                        and dim % sizes[a] == 0:
                    picked = a
                    used.add(a)
                    break
        out.append(picked)
    return tuple(out)


_ATTN_AXES = {"wq": ("embed", "heads", "head_dim"),
              "wk": ("embed", "kv_heads", "head_dim"),
              "wv": ("embed", "kv_heads", "head_dim"),
              "wo": ("heads", "head_dim", "embed"),
              "bq": ("heads", "head_dim"), "bk": ("kv_heads", "head_dim"),
              "bv": ("kv_heads", "head_dim")}
_MIXER_AXES = {
    "attn": _ATTN_AXES, "local": _ATTN_AXES,
    "ssd": {"w_z": ("embed", "ssm_inner"), "w_x": ("embed", "ssm_inner"),
            "w_bc": ("embed", None), "w_dt": ("embed", "ssm_heads"),
            "conv_x_w": (None, "ssm_inner"), "conv_x_b": ("ssm_inner",),
            "conv_bc_w": (None, None), "conv_bc_b": (None,),
            "a_log": ("ssm_heads",), "dt_bias": ("ssm_heads",),
            "d_skip": ("ssm_heads",), "norm_scale": ("ssm_inner",),
            "w_out": ("ssm_inner", "embed")},
    "rglru": {"w_x": ("embed", "lru"), "w_gate": ("embed", "lru"),
              "conv_w": (None, "lru"), "conv_b": ("lru",),
              "w_r": ("lru", "lru_in"), "b_r": ("lru",),
              "w_i": ("lru", "lru_in"), "b_i": ("lru",), "lam": ("lru",),
              "w_out": ("lru", "embed")},
}
_GROUP_AXES = {
    "norm1": {"scale": ("embed",)}, "norm2": {"scale": ("embed",)},
    "mlp": {"wi": ("embed", "ffn"), "wg": ("embed", "ffn"),
            "wo": ("ffn", "embed")},
    "moe": {"router": ("embed", "experts_r"),
            "wi": ("experts", "expert_embed", "expert_ffn"),
            "wg": ("experts", "expert_embed", "expert_ffn"),
            "wo": ("experts", "expert_ffn", "expert_embed")},
    # the stack's own leaves
    "embed": {"table": ("vocab", "embed")},
    "final_norm": {"scale": ("embed",)},
    "unembed": {"w": ("embed", "vocab")},
    "frontend": {"proj": (None, "embed")},
}


def block_axes(mixer: str) -> Dict[str, Dict[str, tuple]]:
    """The logical axes of one block's leaves (the reference's
    ``block_schema`` axes), ``{group: {name: axes}}``."""
    return dict(_GROUP_AXES, mixer=_MIXER_AXES[mixer])


def param_axes(cfg) -> Dict[str, Any]:
    """The logical axes of every leaf of ``cfg``'s LM stack, a tree of the
    parameters' structure (a stacked period's leaves lead with
    ``"layers"``): the reference's ``model_schema`` axes."""
    from repro_torch.models import transformer as T

    out: Dict[str, Any] = {}
    for key, sub in T._model_shapes(cfg).items():
        if key in ("periods", "remainder"):
            lead = ("layers",) if key == "periods" else ()
            out[key] = {b: {g: {n: lead + block_axes(
                cfg.block_pattern[int(b[3:])])[g][n] for n in leaves}
                for g, leaves in s.items()} for b, s in sub.items()}
        else:
            out[key] = {n: _GROUP_AXES[key][n] for n in sub}
    return out


def train_specs(cfg, mesh_shape, *, fsdp: bool = True,
                pure_dp: bool = False) -> Dict[str, Any]:
    """The training spec of every leaf (:func:`spec_for` of its logical
    axes, the reference's ``param_pspecs`` on ``make_test_mesh``), a tree
    of the parameters' structure; ``pure_dp``: every leaf whole.  Raises
    where the reference's expert-parallel dispatch cannot place a float
    stack's experts (``E`` or, with ``fsdp``, their ``d_ff`` not
    divisible)."""
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    data, model = mesh_shape
    if cfg.is_moe and not cfg.spiking and not pure_dp:
        if model > 1:
            M.expert_block(cfg.num_experts, model)
        if fsdp and data > 1 and cfg.d_ff % data:
            raise ValueError(f"{cfg.name}: the experts' d_ff {cfg.d_ff} does "
                             f"not split over data={data} (fsdp)")
    sizes = {"data": data, "model": model}
    over = dict.fromkeys(RULES, ()) if pure_dp else None

    def walk(axes, shapes):
        if isinstance(axes, dict):
            return {k: walk(axes[k], shapes[k]) for k in axes}
        return spec_for(axes, shapes, sizes, fsdp=fsdp, overrides=over)

    return walk(param_axes(cfg), T._model_shapes(cfg))


def block_spec(specs, group: str, name: str) -> Tuple[Optional[str], ...]:
    """The spec of a block leaf in any block of ``specs``
    (:func:`train_specs`), over one layer's axes; ``()`` where the stack
    has no such leaf."""
    for key in ("periods", "remainder"):
        for blk in specs.get(key, {}).values():
            if name in blk.get(group, {}):
                spec = blk[group][name]
                return spec[1:] if key == "periods" else spec
    return ()


def any_cut(specs) -> bool:
    """Whether a :func:`train_specs` tree cuts any leaf."""
    if isinstance(specs, dict):
        return any(any_cut(v) for v in specs.values())
    return any(a is not None for a in specs)


def param_placement(cfg, mesh_shape, *, device, model_index: int = 0,
                    serving: bool = False, data_index: int = 0,
                    fsdp: bool = True, pure_dp: bool = False
                    ) -> Dict[str, Any]:
    """A rank's :class:`Placement` of every parameter of ``cfg``'s LM
    stack, a tree of the parameters' structure (a spiking linear's
    placement covers its whole subtree: a float weight, ``{"levels",
    "scale", "b"}`` or a programmed state).  ``serving=False``: the
    training cut (:func:`train_specs`) of the rank at ``(data_index,
    model_index)``; ``serving``: the ``model`` cut of rank ``model_index``
    (:func:`model_cut`)."""
    from repro_torch.models import transformer as T

    data, model = mesh_shape
    if data < 1 or model < 1:
        raise ValueError(f"mesh shape {tuple(mesh_shape)} holds no rank")
    whole = Placement(torch.device(device))
    if not serving:
        specs = train_specs(cfg, mesh_shape, fsdp=fsdp, pure_dp=pure_dp)

        def place(spec):
            if isinstance(spec, dict):
                return {k: place(v) for k, v in spec.items()}
            if not any(spec):
                return whole
            return Placement(whole.device, spec=spec,
                             mesh_shape=(data, model),
                             coords=(data_index, model_index))

        return place(specs)
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
    :func:`train_specs` cuts, MoE tokens split by sequence over ``model``
    with ``seq_shard``, and with ``fsdp`` every ``embed`` axis (ZeRO-3)
    and the experts' ``d_ff`` over ``data``."""
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
