"""Mesh-sharded serving of the spiking GPT: one process per rank.

Twin of ``repro.distributed``:

    Executor            -- one rank's share of params, programmed PCM state
        |                 and decode state on a (data, model) mesh; the
        |                 data-parallel continuous-batching scheduler
    ShardedBackend      -- tensor-parallel spiking primitives: column- and
        |                 row-parallel crossbar linears (K5 counts summed
        |                 over the model group, then LIF once), head-parallel
        |                 SSA decode on the f(seed, pos, head) streams
    TPPlan / TP_PARTS   -- which leaves the model axis splits

Ranks come from :func:`repro_torch.launch.mesh.run_ranks` (or
``torchrun``); :mod:`repro_torch.distributed.jobs` holds the serve rank
function.  On the integer and CUDA backends a mesh serves the tokens of
one device, bit for bit.
"""

from repro_torch.distributed.backend import TP_PARTS, ShardedBackend, TPPlan
from repro_torch.distributed.executor import Executor

__all__ = ["Executor", "ShardedBackend", "TPPlan", "TP_PARTS"]
