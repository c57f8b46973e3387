"""Parameters from the reference package, through numpy.

The reference's parameter trees are nested dicts (and, for the paper
models, a ``"blocks"`` list) of arrays; on the LM stack ``periods`` leaves
are stacked over a leading period axis.  :func:`params_from_numpy` keeps
that layout (which :mod:`repro_torch.models.transformer` and
:mod:`repro_torch.core.spiking_transformer` read); :func:`layer_params`
unstacks one layer.  Callers convert JAX arrays with
``jax.tree.map(numpy.asarray, params)`` first, so this module needs no
JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch


def params_from_numpy(tree: Any, device: Union[str, torch.device] = "cpu") -> Any:
    """Nested dicts and lists of numpy arrays -> the same tree of torch
    tensors."""
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
