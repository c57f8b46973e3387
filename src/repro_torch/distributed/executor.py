"""Executor: one rank's share of the serving stack on a ``(data, model)``
mesh.

Twin of ``repro/distributed/executor.py``.  Built on every rank (one
process each, :func:`repro_torch.launch.mesh.run_ranks` or ``torchrun``)
from the same whole parameter tree:

* **params** -- float weights are quantised on the whole tree first, then
  each rank keeps its shares of the spiking linears (Q/K/V and MLP in by
  columns, attention and MLP out by rows, :func:`repro_torch.convert.
  shard_params`); programmed :class:`~repro_torch.aimc_device.
  AIMCDeviceState` leaves are cut per field and drift per share (K6 is
  elementwise); GDC sums its calibration reads over the model group.
  Everything else is whole on every rank;
* **backend** -- a :class:`~repro_torch.distributed.backend.
  ShardedBackend` over the inner one when ``model > 1``;
* **scheduler** -- a :class:`~repro_torch.serving.BatchScheduler` with
  this executor as its placement: decode slots split over ``data``, the
  host decisions identical on every rank.

Tokens, drift clock, folds, recalibrations and energy equal the same
engine on one device, bit for bit, and so do the logits of
:meth:`Executor.forward`, the full-sequence forward with the batch split
over ``data``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import convert
from repro_torch.distributed.backend import ShardedBackend
from repro_torch.engine import get_backend
from repro_torch.models import transformer as T


class Executor:
    """The serving stack of one rank (see the module)::

        ex = Executor(params, cfg, "cuda", mesh)   # on every rank
        outs, stats = ex.serve(prompts, max_new=16, slots=8)

    or ``engine.executor(mesh)``.  ``mesh`` is the rank's
    :class:`repro_torch.launch.mesh.ServingMesh`; the executor runs on its
    device.  ``params`` is the whole tree; ``self.params`` holds the
    rank's share, and every scheduler serves that share."""

    def __init__(self, params, cfg, backend, mesh):
        T.require_mesh_supported(cfg)
        if not T.spiking_decode_enabled(cfg):
            raise NotImplementedError(
                f"{cfg.name}: the port's mesh serves the spiking SSA stack; "
                f"the other stacks on a mesh wait: {T.MOE_ITEM}")
        self.mesh = mesh
        self.cfg = cfg
        self.device = mesh.device
        self.model = mesh.model
        inner = get_backend(backend)
        self.backend: Any = (ShardedBackend(inner, mesh, cfg)
                             if self.model > 1 else inner)
        self.params = self._place(params)
        self._schedulers: Dict[Any, Any] = {}

    # -- placement ------------------------------------------------------

    def _place(self, params):
        """This rank's tree, cut once: float linears quantised on the whole
        matrix, then every spiking linear cut to the rank's share."""
        if self.model <= 1:
            return params
        whole = T.quantize_params(params, self.cfg, keep_state=True)
        return convert.shard_params(whole, self.cfg, self.model,
                                    self.mesh.model_index)

    def gdc_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of a GDC calibration read over the model group (a
        rank's states are all split when ``model > 1``)."""
        if self.model <= 1:
            return x
        host = x.to(self.mesh.host_device)
        return self.mesh.all_reduce_model(host).to(x.device)

    # -- forward --------------------------------------------------------

    def forward(self, tokens: torch.Tensor, rng: torch.Tensor
                ) -> torch.Tensor:
        """The full spiking forward on the mesh: tokens ``[B, S]`` ->
        logits ``[B, S, V]``, the whole batch's on every rank, equal to one
        device's bit for bit.  The batch rides ``data`` when ``data``
        divides it (else every rank runs the whole batch, as the
        reference's ``batch_pspec`` replicates it); each rank runs the
        spiking stack on its rows through the sharded backend (Q/K/V and
        MLP in by columns, attention and MLP out by rows, SSA tiles by
        heads, each at its global batch row and head), the rate-decoded
        rows are gathered over the data group (a sum of zero-padded rows:
        exact), and every rank unembeds the whole batch, as one device
        does."""
        tokens = tokens.to(self.device)
        b = tokens.shape[0]
        data = self.mesh.data
        n = b // data if data > 1 and b % data == 0 else b
        b0 = self.mesh.data_index * n if n < b else 0
        x, _ = T.spiking_features(self.params, {"tokens": tokens}, self.cfg,
                                  rng=rng.to(self.device),
                                  backend=self.backend, rows=(b0, n))
        if n < b:
            whole = torch.zeros((b,) + tuple(x.shape[1:]), dtype=x.dtype,
                                device=x.device)
            whole[b0:b0 + n] = x
            x = self.mesh.all_reduce_data(whole)
        return T._unembed(self.params, x, self.cfg)

    # -- data-parallel continuous batching ------------------------------

    def scheduler(self, *, slots: int = 4, cache_len: int = 64, drift=None,
                  paged: bool = False, page_len: int = 8,
                  n_pages: Optional[int] = None,
                  decode_kernel: str = "auto"):
        """This rank's :class:`repro_torch.serving.BatchScheduler` (cached
        per geometry; reset and given the executor's params on reuse)."""
        from repro_torch.serving import BatchScheduler

        key = (slots, cache_len, paged, decode_kernel) + (
            (page_len, n_pages) if paged else ())
        sch = self._schedulers.get(key)
        if sch is not None:
            sch.reset()
            if sch.source_params is not self.params:
                sch.set_params(self.params)
            sch.drift = drift
            return sch
        sch = BatchScheduler(self.params, self.cfg, self.backend, slots=slots,
                             cache_len=cache_len, decode_kernel=decode_kernel,
                             paged=paged, page_len=page_len, n_pages=n_pages,
                             drift=drift, placement=self)
        self._schedulers[key] = sch
        return sch

    def serve(self, prompts, max_new: int = 16, *, slots: int = 4,
              cache_len: int = 64, seed: int = 0, drift=None,
              paged: bool = False, page_len: int = 8,
              n_pages: Optional[int] = None, decode_kernel: str = "auto"):
        """Continuous-batching serve on the mesh -> ``(outputs,
        ServeStats)``, the same on every rank; request ``i`` draws from the
        stream ``seed + i``.  Under a drift policy the executor adopts the
        aged state (this rank's shares)."""
        sch = self.scheduler(slots=slots, cache_len=cache_len, drift=drift,
                             paged=paged, page_len=page_len, n_pages=n_pages,
                             decode_kernel=decode_kernel)
        rids = [sch.submit(p, max_new, seed=seed + i)
                for i, p in enumerate(prompts)]
        outs = sch.run()
        if sch.programmed:
            self.params = sch.source_params
        return [outs[r] for r in rids], sch.stats
