"""Elastic scaling: the placement plan of a changed mesh.

Twin of ``repro.launch.elastic``.  A restart may come up on another mesh
(fewer or more ranks, or a serving mesh after training).  Checkpoints
hold every leaf whole (:mod:`repro_torch.checkpoint.manager`), so restore
reads each rank's piece with placements computed for the new mesh: a pure
function of ``(config, mesh shape, rank)``
(:func:`repro_torch.parallel.sharding.param_placement`).

:func:`resharding_plan` reports what changes between two meshes, for
operator logs.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.optim import adamw as A
from repro_torch.parallel import sharding as SH


def state_shardings(cfg, mesh_shape: Tuple[int, int], opt: A.AdamWConfig, *,
                    device, rank: int = 0, serving: bool = False):
    """``(param placement, opt-state placement)`` of rank ``rank`` of a
    ``mesh_shape`` mesh, each leaf on ``device``: the prefix trees
    :meth:`repro_torch.checkpoint.CheckpointManager.restore` reads a
    training state ``(params, opt_state)`` with.

    On a data-parallel training mesh every rank holds the whole state
    (``model > 1`` raises: ROADMAP A2(c)), so one placement covers the
    whole optimizer state of any ``opt`` (moments of each state dtype,
    ``step``, EF residuals).  ``serving``: the parameters' model cut of
    the rank's ``model_index``, and no optimizer state (``None``: not
    read)."""
    params = SH.param_placement(cfg, mesh_shape, device=device,
                                model_index=rank % mesh_shape[1],
                                serving=serving)
    if serving:
        return params, None
    return params, SH.Placement(torch.device(device))


def resharding_plan(cfg, old_shape: Tuple[int, int],
                    new_shape: Tuple[int, int], *, serving: bool = False
                    ) -> Dict[str, Any]:
    """The parameter layouts of two meshes compared (for logs and
    validation): the reference's keys ``old_mesh``, ``new_mesh``,
    ``n_params_relaid`` and ``changes`` (the first 32)."""
    def specs(shape):
        return SH.placement_specs(SH.param_placement(
            cfg, shape, device="cpu", serving=serving))

    old, new = specs(old_shape), specs(new_shape)
    changed = [{"param": path, "old": old[path], "new": new[path]}
               for path in old if old[path] != new[path]]
    return {
        "old_mesh": dict(zip(("data", "model"), tuple(old_shape))),
        "new_mesh": dict(zip(("data", "model"), tuple(new_shape))),
        "n_params_relaid": len(changed),
        "changes": changed[:32],
    }
