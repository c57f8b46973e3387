"""Parameters from the reference package, through numpy.

The reference's parameter trees are nested dicts (and, for the paper
models, a ``"blocks"`` list) of arrays; on the LM stack ``periods`` leaves
are stacked over a leading period axis.  :func:`params_from_numpy` keeps
that layout (which :mod:`repro_torch.models.transformer` and
:mod:`repro_torch.core.spiking_transformer` read); :func:`layer_params`
unstacks one layer.  Callers convert JAX arrays with
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


def params_from_numpy(tree: Any, device: Union[str, torch.device] = "cpu") -> Any:
    """Nested dicts and lists of numpy arrays -> the same tree of torch
    tensors (device states -> :class:`AIMCDeviceState`)."""
    if _is_device_state(tree):
        return device_state_from_numpy(tree, device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


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
