"""Executor: one rank's share of the serving stack on a ``(data, model)``
mesh.

Twin of ``repro/distributed/executor.py``.  Built on every rank (one
process each, :func:`repro_torch.launch.mesh.run_ranks` or ``torchrun``)
from the same parameter tree, for every registry config:

* **params** -- a spiking SSA stack's float weights are quantised on the
  whole tree first, then each rank keeps its shares of the spiking
  linears whose block part splits (Q/K/V and MLP in by columns, attention
  and MLP out by rows, :func:`repro_torch.convert.shard_params`; a part
  whose heads or columns ``model`` does not divide is held whole);
  programmed :class:`~repro_torch.aimc_device.AIMCDeviceState` leaves are
  cut per field and drift per share (K6 is elementwise); GDC sums its
  calibration reads over the model group.  A float stack's MoE experts
  are cut into blocks of ``E / model`` (a leaf already holding the rank's
  block is kept).  Everything else is whole on every rank, as the
  reference replicates it;
* **backend** -- a :class:`~repro_torch.distributed.backend.
  ShardedBackend` over the inner one for a spiking SSA stack when
  ``model > 1``; a float stack gets none (its products are plain torch);
* **pctx** -- the :class:`~repro_torch.models.moe.ParallelCtx` of the
  rank, the reference's ``ParallelCtx(dp_axes=("data",),
  tp_axis="model")``: a float MoE block's dispatch all-to-alls over the
  model group;
* **scheduler** -- a :class:`~repro_torch.serving.BatchScheduler` with
  this executor as its placement: decode slots split over ``data``, the
  host decisions identical on every rank.

Tokens, drift clock, folds, recalibrations and energy of a spiking stack
equal the same engine on one device, bit for bit, and so do the logits of
:meth:`Executor.forward`.  A float stack's streams are the reference
executor's; a MoE stack's decode routes each data rank's slots with the
reference's per-device capacities, so its tokens equal one device's where
neither drops a choice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import convert
from repro_torch.distributed.backend import ShardedBackend
from repro_torch.engine import get_backend
from repro_torch.models import moe as M
from repro_torch.models import transformer as T


class Executor:
    """The serving stack of one rank (see the module)::

        ex = Executor(params, cfg, "cuda", mesh)   # on every rank
        outs, stats = ex.serve(prompts, max_new=16, slots=8)

    or ``engine.executor(mesh)``.  ``mesh`` is the rank's
    :class:`repro_torch.launch.mesh.ServingMesh`; the executor runs on its
    device.  ``params`` is the whole tree (or, for a float MoE stack, one
    holding the rank's block of experts); ``self.params`` holds the rank's
    share, and every scheduler serves that share.  A MoE stack takes the
    reference's default ``moe_impl``, ``"ep_a2a"``."""

    def __init__(self, params, cfg, backend, mesh):
        self.mesh = mesh
        self.cfg = cfg
        self.device = mesh.device
        self.model = mesh.model
        self.spiking = T.spiking_decode_enabled(cfg)
        self.pctx = M.ParallelCtx(mesh)
        inner = get_backend(backend)
        self.backend: Any = (ShardedBackend(inner, mesh, cfg)
                             if self.spiking and self.model > 1 else inner)
        self.params = self._place(params)
        self._schedulers: Dict[Any, Any] = {}

    # -- placement ------------------------------------------------------

    def _place(self, params):
        """This rank's tree, cut once: a spiking stack's float linears
        quantised on the whole matrix, then each split linear cut to the
        rank's share; a float stack's experts cut to the rank's block."""
        if self.model <= 1:
            return params
        if self.spiking:
            params = T.quantize_params(params, self.cfg, keep_state=True)
        return convert.shard_params(params, self.cfg, self.model,
                                    self.mesh.model_index)

    def gdc_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of a GDC calibration read over the model group (a
        rank's states are all split when ``model > 1``)."""
        if self.model <= 1:
            return x
        host = x.to(self.mesh.host_device)
        return self.mesh.all_reduce_model(host).to(x.device)

    # -- forward --------------------------------------------------------

    def _rows(self, b: int):
        """This rank's batch rows ``(b0, n)``: the batch rides ``data``
        when ``data`` divides it, else every rank runs it whole (as the
        reference's ``batch_pspec`` replicates it)."""
        data = self.mesh.data
        n = b // data if data > 1 and b % data == 0 else b
        return (self.mesh.data_index * n if n < b else 0), n

    def _gather_rows(self, x: torch.Tensor, b0: int, b: int) -> torch.Tensor:
        """The whole batch from each data rank's rows (a sum over the data
        group of zero-padded rows: exact)."""
        n = x.shape[0]
        if n == b:
            return x
        whole = torch.zeros((b,) + tuple(x.shape[1:]), dtype=x.dtype,
                            device=x.device)
        whole[b0:b0 + n] = x
        return self.mesh.all_reduce_data(whole)

    def forward(self, tokens, rng: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """The full forward on the mesh: tokens ``[B, S]`` (or a batch
        dict: a frontend arch's ``{"embeddings": [B, S, F]}``) -> logits
        ``[B, S, V]``, the whole batch's on every rank.

        A spiking SSA stack (``rng`` its coding key) runs its rows through
        the sharded backend (Q/K/V and MLP in by columns, attention and MLP
        out by rows, SSA tiles by heads, each at its global batch row and
        head), the rate-decoded rows are gathered over the data group, and
        every rank unembeds the whole batch: one device's logits, bit for
        bit.  A float stack without MoE runs its rows and the logits are
        gathered.  A float MoE stack runs the whole batch on every rank with
        one device's capacities, its experts' products split over the model
        group, as the reference's mesh forward (which passes no ``pctx``)
        computes it."""
        batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
        batch = {k: v.to(self.device) for k, v in batch.items()}
        b = next(iter(batch.values())).shape[0]
        if self.cfg.is_moe and not self.cfg.spiking:
            pctx = M.ParallelCtx(self.mesh, whole_batch=True)
            return T.forward(self.params, batch, self.cfg, remat="none",
                             pctx=pctx)[0]
        b0, n = self._rows(b)
        rng = None if rng is None else rng.to(self.device)
        if self.spiking:
            x, _ = T.spiking_features(self.params, batch, self.cfg, rng=rng,
                                      backend=self.backend, rows=(b0, n))
            return T._unembed(self.params, self._gather_rows(x, b0, b),
                              self.cfg)
        logits, _ = T.forward(self.params, batch, self.cfg,
                              rng=rng, backend=self.backend, remat="none",
                              rows=(b0, n) if n < b else None)
        return self._gather_rows(logits, b0, b)

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
