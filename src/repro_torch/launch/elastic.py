"""Elastic scaling: the placement plan of a changed mesh.

Twin of ``repro.launch.elastic``.  A restart may come up on another mesh
(fewer or more ranks, a model axis or none, or a serving mesh after
training).  Checkpoints hold every leaf whole (:mod:`repro_torch.
checkpoint.manager`; a cut state is gathered whole on the writer's host
before it is written, :func:`gather_whole`), so restore reads each rank's
piece with placements computed for the new mesh: a pure function of
``(config, mesh shape, rank)`` (:func:`repro_torch.parallel.sharding.
param_placement`).

:func:`resharding_plan` reports what changes between two meshes, for
operator logs.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.parallel import sharding as SH


def state_shardings(cfg, mesh_shape: Tuple[int, int], opt, *,
                    device, rank: int = 0, serving: bool = False,
                    fsdp: bool = True, pure_dp: bool = False):
    """``(param placement, opt-state placement)`` of rank ``rank`` of a
    ``mesh_shape`` mesh, each leaf on ``device``: the prefix trees
    :meth:`repro_torch.checkpoint.CheckpointManager.restore` reads a
    training state ``(params, opt_state)`` with.

    On a training mesh each rank holds its cut
    (:func:`repro_torch.parallel.sharding.train_specs`; ``fsdp`` and
    ``pure_dp`` as the train step's :class:`repro_torch.configs.
    ParallelConfig`), and the moments (and EF residuals) follow their
    parameters' placement, ``step`` whole; where nothing is cut one
    placement covers the whole optimizer state of any ``opt``.
    ``serving``: the parameters' model cut of the rank's
    ``model_index``, and no optimizer state (``None``: not read)."""
    data_index, model_index = divmod(rank, mesh_shape[1])
    params = SH.param_placement(cfg, mesh_shape, device=device,
                                model_index=model_index,
                                data_index=data_index, serving=serving,
                                fsdp=fsdp, pure_dp=pure_dp)
    if serving:
        return params, None
    whole = SH.Placement(torch.device(device))
    if not SH.any_cut(SH.train_specs(cfg, mesh_shape, fsdp=fsdp,
                                     pure_dp=pure_dp)):
        return params, whole
    return params, {"m": params, "v": params, "ef": params, "step": whole}


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


def gather_whole(state, placement, mesh, writer: int = 0):
    """A training rank's cut ``state`` (a prefix ``placement``, as
    :func:`state_shardings` gives it) gathered whole on the host of rank
    ``writer``, what a checkpoint writes; ``None`` on every other rank.
    A leaf at a time: each cut leaf is all-gathered over the axes that cut
    it and moved to the host, so a rank's device holds one whole leaf at
    a time, not the whole state.  Every rank of the mesh must call it."""
    from repro_torch.checkpoint.manager import map_with_placement

    mine = mesh.rank == writer

    def whole(x, where, field):
        if where is not None and not where.whole and where.spec:
            spec = where.spec[:-1] if field == "scale" else where.spec
            for ax, name in enumerate(spec):
                if where.axis_size(name) > 1:
                    x = mesh.all_gather(x.detach(), ax, name)
        if not mine:
            return None
        return x.detach().cpu() if isinstance(x, torch.Tensor) else x

    out = map_with_placement(whole, state, placement)
    return out if mine else None
