"""Parameters from the reference package, through numpy.

The reference's parameter trees are nested dicts (and, for the paper
models, a ``"blocks"`` list) of arrays; on the LM stack ``periods`` leaves
are stacked over a leading period axis.  :func:`params_from_numpy` keeps
that layout (which :mod:`repro_torch.models.transformer` and
:mod:`repro_torch.core.spiking_transformer` read); :func:`layer_params`
unstacks one layer; :func:`shard_params` cuts the share of one rank of a
``(data, model)`` mesh.  Callers convert JAX arrays with
``jax.tree.map(numpy.asarray, params)`` first, so this module needs no
JAX.  Programmed PCM state (the reference's ``AIMCDeviceState``, whose
leaves that map turns into numpy arrays) becomes the port's
:class:`repro_torch.aimc_device.AIMCDeviceState` on the way
(:func:`device_state_from_numpy`).
"""

from __future__ import annotations

from typing import Any, Dict, Union

import dataclasses

import numpy as np
import torch

from repro_torch.aimc_device import AIMCDeviceState
from repro_torch.device import resolve_device

_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(AIMCDeviceState))


def _is_device_state(x: Any) -> bool:
    return all(hasattr(x, f) for f in _STATE_FIELDS)


def device_state_from_numpy(state: Any, device: Union[str, torch.device] = "cpu"
                            ) -> AIMCDeviceState:
    """A reference ``AIMCDeviceState`` with numpy leaves -> the port's, its
    tensors on ``device``, every value and dtype kept."""
    return AIMCDeviceState(*(
        torch.from_numpy(np.array(getattr(state, f), copy=True)).to(device)
        for f in _STATE_FIELDS))


def params_from_numpy(tree: Any, device: Union[str, torch.device, None] = None
                      ) -> Any:
    """Nested dicts and lists of numpy arrays -> the same tree of torch
    tensors (device states -> :class:`AIMCDeviceState`) on ``device`` (the
    card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    if _is_device_state(tree):
        return device_state_from_numpy(tree, device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    a = np.array(tree, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy view in torch
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a).to(device)


def opt_state_from_numpy(state: Any, device: Union[str, torch.device, None]
                         = None) -> Any:
    """A reference AdamW state (``repro.optim.adamw.init_opt_state`` or a
    later one, through ``jax.tree.map(numpy.asarray, state)``) -> the
    port's (:mod:`repro_torch.optim.adamw`): ``m``/``v`` mirror the
    parameter tree (an int8 moment a ``{"q", "scale"}`` dict), ``step``
    an int32 scalar, ``ef`` (compression's residuals) where present; every
    value and dtype kept, on ``device``."""
    return params_from_numpy(state, device)


def layer_params(params: Dict[str, Any], cfg, layer: int) -> Dict[str, Any]:
    """The parameters of decoder layer ``layer`` (a view into the stacked
    ``periods`` leaves, or the matching ``remainder`` block)."""
    n = cfg.num_periods * cfg.period
    if layer < n:
        p, i = divmod(layer, cfg.period)

        def take(t):
            return {k: take(v) for k, v in t.items()} if isinstance(t, dict) else t[p]

        return take(params["periods"][f"blk{i}"])
    return params["remainder"][f"blk{layer - n}"]


def _cut(x, axis: int, model: int, index: int):
    n = x.shape[axis] // model
    return x.narrow(axis, index * n, n).contiguous()


def _shard_leaf(leaf, part: str, dims, model: int, index: int):
    """One spiking linear's rank share: ``col`` cuts the output columns
    (levels and scale, bias), ``row`` the input rows (levels; the scale and
    bias stay whole).  The leaf must be the whole matrix."""
    d_in, d_out = dims
    shape = tuple(leaf.shape if isinstance(leaf, AIMCDeviceState)
                  else leaf["levels"].shape)[-2:]
    if shape != (d_in, d_out):
        raise ValueError(f"a {part} leaf of shape {shape} is not the whole "
                         f"matrix {(d_in, d_out)}")
    mat_axis = -1 if part == "col" else -2

    def mat(x):
        return _cut(x, mat_axis, model, index)

    def vec(x):
        return _cut(x, -1, model, index) if part == "col" else x

    if isinstance(leaf, AIMCDeviceState):
        return dataclasses.replace(
            leaf, levels=mat(leaf.levels), eps=mat(leaf.eps),
            nu=mat(leaf.nu), levels_t=mat(leaf.levels_t),
            scale=vec(leaf.scale))
    out = {"levels": mat(leaf["levels"]), "scale": vec(leaf["scale"])}
    if leaf.get("b") is not None:
        out["b"] = vec(leaf["b"])
    return out


def _shard_experts(w, model: int, index: int, n_experts: int):
    """A MoE leaf's block of experts (its axis -3): contiguous, ``E /
    model`` of them.  A leaf already holding one block is the rank's own
    (drawn or restored as its share) and is kept."""
    e = w.shape[-3]
    if e == n_experts // model:
        return w
    if e != n_experts:
        raise ValueError(f"a MoE leaf of {e} experts is neither the whole "
                         f"{n_experts} nor a block of {n_experts // model}")
    return _cut(w, -3, model, index)


def shard_params(params: Dict[str, Any], cfg, model: int, index: int
                 ) -> Dict[str, Any]:
    """The tree rank ``index`` of the ``model`` axis holds
    (:func:`repro_torch.parallel.sharding.model_cut`): a spiking SSA
    stack's linears of each block part that splits cut per
    :data:`repro_torch.distributed.backend.TP_PARTS` (Q/K/V and MLP in by
    columns, attention and MLP out by rows, whole heads and contiguous
    blocks), a float stack's MoE experts (``wi``, ``wg``, ``wo [.., E,
    ...]``) in contiguous blocks of ``E / model``, everything else whole.

    Linear leaves are quantised operands ``{"levels", "scale"}`` (cut
    after quantising the whole matrix, so a share's levels and scales are
    the whole matrix's, and no cross-rank max is needed) or programmed
    :class:`AIMCDeviceState` (matrix fields and, by columns, ``scale`` are
    cut; the clock, ``gdc_gain`` and ``img_inv`` stay whole, as JAX's
    ``_state_specs`` places them).  ``model == 1`` returns the tree."""
    from repro_torch.distributed.backend import mat_dims
    from repro_torch.parallel.sharding import model_cut

    cut = model_cut(cfg, model)
    if not cut:
        return params

    def block(blk):
        out = dict(blk)
        for group in ("mixer", "mlp", "moe"):
            if group not in blk:
                continue
            g = dict(blk[group])
            for name, w in blk[group].items():
                part = cut.get((group, name))
                if part == "experts":
                    g[name] = _shard_experts(w, model, index, cfg.num_experts)
                elif part is not None:
                    if not isinstance(w, (dict, AIMCDeviceState)):
                        raise ValueError(
                            f"{group}.{name}: quantise float weights "
                            "before sharding (quantize_params)")
                    g[name] = _shard_leaf(w, part,
                                          mat_dims(cfg, group, name), model,
                                          index)
            out[group] = g
        return out

    out = dict(params)
    for grp in ("periods", "remainder"):
        if grp in params:
            out[grp] = {k: block(v) for k, v in params[grp].items()}
    return out


def params_to_numpy(tree: Any) -> Any:
    """The inverse of :func:`params_from_numpy`: a tree of tensors (device
    states kept as :class:`AIMCDeviceState` of numpy arrays) as plain
    picklable data, e.g. for the ranks of a mesh."""
    if isinstance(tree, AIMCDeviceState):
        return tree.map(lambda x: x.detach().cpu().numpy())
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree
