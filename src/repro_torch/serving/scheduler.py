"""BatchScheduler: continuous batching, dense or block-paged.

Twin of ``repro/serving/scheduler.py``:

* **dense** (:class:`~repro_torch.serving.state.DecodeState`) -- queued
  requests splice into free slots mid-flight, each prefilled batch-1
  through the unfused decode path (the K1 spiking linear and K2 SSA-decode
  kernels on the card); one batched step advances every slot through the
  fused layer kernel (K3), once per layer; a finished slot's cache is
  zeroed.
* **paged** (``paged=True``; :class:`~repro_torch.serving.state.
  PagedDecodeState` + :class:`~repro_torch.serving.pages.PagePool`) --
  K/V spike trains live in a global page pool: refcounted pages with
  copy-on-write, an exact-prefix cache that maps identical prompt prefixes
  onto the *same physical pages* (prefill PRN streams are content-keyed),
  **chunked prefill** (prompt tokens ride the batched step, one position
  per step per prefilling slot, through the paged fused layer kernel K9),
  and admission that blocks on *free pages*, first in first out.

Per-slot PRN streams ``f(seed, pos)`` make a request's tokens a pure
function of ``(params, prompt, seed)``, never of batch composition or
layout: paged and dense serving give the same tokens.

* **float stacks** (a non-spiking config, or a spiking one whose
  attention is not SSA) serve dense on the float decode path
  (:func:`repro_torch.models.transformer.decode_step`): no decode plan,
  no kernel of the port, the per-slot caches ``{k, v, pos}`` (a ring
  buffer for a windowed layer), ``{ssd, conv_x, conv_bc, pos}`` or ``{h,
  conv, pos}``; ``decode_kernel="fused"`` and ``paged=True`` raise, and
  the metered energy is zero, as in the reference.  A MoE stack
  (:mod:`repro_torch.models.moe`) routes each step's slots through
  ``moe_impl``; a spiking SSA MoE stack serves dense or paged, unfused
  (its FFN runs on the rate interface).

* **energy** -- every served position (a dense prefill at admission, a
  decode or paged prompt position) books its measured residual-stream
  spike events times the per-event op energy plus the static per-token
  cost (:mod:`repro_torch.energy.model`) against its request
  (:attr:`BatchScheduler.request_energy_j`) and :class:`ServeStats`;
* **drift lifecycle** -- with programmed params and a
  :class:`~repro_torch.aimc_device.DriftPolicy`, every batched step
  advances the PCM clock, re-folds the int8 image (K6) once the drift
  factor has moved by half an image step, and runs GDC every
  ``recal_interval_s``; after each fold the step's operands are derived
  again from the aged state.

* **mesh** (``placement=``, a :class:`repro_torch.distributed.Executor`)
  -- one scheduler per rank of a ``(data, model)`` mesh, all making the
  same host decisions from the same submits: ``params`` is the rank's
  share (the executor cuts it), a rank's device state holds
  its data block of slots (and its model share of a spiking stack's KV
  heads; a float stack's caches are whole over the model group), its
  decode step computes those slots (a MoE block routing them over the
  model group through the executor's ``pctx``), and each step's tokens
  and activity are gathered over the data group; a batch-1 prefill runs
  on every data rank (tensor- or expert-parallel over the model group)
  and only the slot's owner splices it; the page pool is whole on every
  data rank, and each step's new K/V rows are exchanged over the data
  group; a wall-clock drift step is rank 0's.

* **telemetry** (``obs=``, a :class:`repro_torch.obs.Telemetry`) --
  host-side bookkeeping only: lifecycle trace events (submit, admit,
  prefill chunk, first token, decode, finish, evict, preempt, GDC
  recalibration), counters mirroring :class:`ServeStats` by delta once a
  step, occupancy and pool gauges read from Python state, a decode-step
  latency histogram and the profiler window's tick.  Attaching it changes
  no token and no joule, and adds no kernel launch and no host-device
  synchronisation to a step; the mean GDC gain is read from the device at
  attach and after each recalibration only.  :meth:`free_slots`,
  :meth:`queued_requests`, :meth:`slot_of` and :meth:`preempt` are what
  the front door (:mod:`repro_torch.server`) drives.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import aimc_device as AD
from repro_torch.device import resolve_device
from repro_torch.energy import model as EM
from repro_torch.engine import get_backend
from repro_torch.kernels.plan import build_decode_plan
from repro_torch.models import transformer as T
from repro_torch.obs import Telemetry
from repro_torch.obs import trace as TR
from repro_torch.parallel import sharding as SH
from repro_torch.serving import state as ST
from repro_torch.serving.pages import PagePool

# paged-slot lifecycle: consuming prompt positions -> feeding the last
# prompt token on the request's own PRN stream -> riding greedy argmax
PREFILL, HANDOFF, DECODE = "prefill", "handoff", "decode"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [P] int64
    max_new: int
    seed: int
    ckeys: np.ndarray  # content keys of the prompt context (prompt[:-1])

    @property
    def n_ctx(self) -> int:
        return len(self.prompt) - 1


@dataclasses.dataclass
class ServeStats:
    requests: int = 0
    data_shards: int = 1  # mesh data-axis size (1 = one device)
    model_shards: int = 1  # mesh model-axis size
    decode_steps: int = 0
    decoded_tokens: int = 0
    prefill_tokens: int = 0
    admissions: int = 0
    evictions: int = 0
    wall_s: float = 0.0  # whole serve loop (admission/prefill included)
    decode_s: float = 0.0  # batched decode steps only
    prefill_s: float = 0.0  # batch-1 prefills at admission (dense)
    spike_events: float = 0.0  # measured residual-stream spike events
    energy_j: float = 0.0  # metered inference energy (events x op energies)
    t_device_s: float = 0.0  # PCM device clock after the last step
    recalibrations: int = 0  # GDC recalibrations run by the drift policy
    image_folds: int = 0  # drift re-folds of the int8 image (K6 per leaf)
    peak_active_slots: int = 0
    # paged serving (zeros on the dense path)
    prefix_hits: int = 0  # prefix-cache page hits across admissions
    prefix_hit_tokens: int = 0  # prompt positions skipped via shared pages
    cow_copies: int = 0  # copy-on-write page duplications
    pages_in_use_peak: int = 0  # peak simultaneously referenced pool pages

    @property
    def tokens_per_sec(self) -> float:
        """Decoded tokens per second of the whole loop (prefill included)."""
        return self.decoded_tokens / max(self.wall_s, 1e-9)

    @property
    def decode_tokens_per_sec(self) -> float:
        """Decoded tokens per second spent inside batched decode steps."""
        return self.decoded_tokens / max(self.decode_s, 1e-9)

    @property
    def j_per_token(self) -> float:
        """Metered joules per decoded token (0 decoded tokens count as a
        vanishing denominator, so booked energy is never hidden)."""
        return self.energy_j / max(self.decoded_tokens, 1e-9)


class BatchScheduler:
    """Continuous-batching scheduler: submit prompts, run, collect outputs.

    Greedy decoding; a request finishes after ``max_new`` tokens.  Outputs
    land in :attr:`outputs` (rid -> generated token ids).  ``params`` is
    the model tree (float weights, as :func:`repro_torch.models.
    transformer.init_params` or :mod:`repro_torch.convert` make them, or
    programmed state from :func:`repro_torch.aimc_device.program_lm_tree`);
    the scheduler moves it to ``device`` and derives the spiking linears'
    operands once (and after every drift fold).  ``drift`` runs the PCM
    lifecycle on programmed params.  ``obs`` attaches a telemetry bundle
    (:meth:`attach_obs`).  ``moe_impl`` (default: ``"ep_a2a"`` for a MoE
    config, the reference's) is a float stack's MoE path at decode and
    prefill.  ``device`` defaults to CUDA and raises without it.
    """

    def __init__(self, params: Any, cfg, backend=None, *, slots: int = 4,
                 cache_len: int = 64, decode_kernel: str = "auto",
                 paged: bool = False, page_len: int = 8,
                 n_pages: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda",
                 drift: Optional[AD.DriftPolicy] = None, placement=None,
                 obs: Optional[Telemetry] = None,
                 moe_impl: Optional[str] = None):
        self.placement = placement  # repro_torch.distributed.Executor | None
        pctx = None
        if placement is not None:
            device = placement.device
            mesh = placement.mesh
            self._own = SH.slot_range(slots, mesh.data, mesh.data_index)
            self._kv_local = SH.local_kv_heads(cfg, mesh.model)
            pctx = placement.pctx
        else:
            self._own = range(slots)
            self._kv_local = None
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the unembed is a float32 matmul: keep it out of TF32
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.backend = get_backend(backend)
        self.slots = slots
        self.cache_len = cache_len
        self.paged = bool(paged)
        self.drift = drift
        # a float MoE stack's decode and prefill path (a spiking one's MoE
        # runs dense on the rate interface), as the reference resolves it
        self.moe_impl = moe_impl or ("ep_a2a" if cfg.is_moe else "dense")
        # one plan per scheduler lifetime for a spiking SSA stack (dense
        # prefill always runs unfused); the float decode has none
        self.spiking = T.spiking_decode_enabled(cfg)
        if self.spiking:
            self.plan = build_decode_plan(
                cfg, self.backend, layout="paged" if self.paged else "dense",
                kernel=decode_kernel, page_len=page_len)
        elif decode_kernel == "fused":
            raise ValueError("decode kernel 'fused' needs a spiking SSA "
                             f"config, not {cfg.name!r}")
        else:
            self.plan = None
        if self.paged:
            if not T.paged_decode_supported(cfg):
                raise ValueError("paged serving needs a spiking SSA stack of "
                                 f"attention blocks, not {cfg.name!r}")
            if cache_len % page_len:
                raise ValueError(f"cache_len ({cache_len}) must be a multiple "
                                 f"of page_len ({page_len})")
            self.page_len = page_len
            self.max_pages = cache_len // page_len
            # default pool: the cache memory a dense server of this slot
            # count holds (prefix sharing turns it into extra concurrency)
            self.n_pages = (slots * self.max_pages + ST.RESERVED_PAGES
                            if n_pages is None else n_pages)
            self._decode = ST.make_paged_decode_fn(cfg, self.backend,
                                                   plan=self.plan)
        else:
            self._decode = ST.make_decode_fn(cfg, self.backend, plan=self.plan,
                                             moe_impl=self.moe_impl, pctx=pctx)
            self._prefill = ST.make_prefill_fn(cfg, self.backend,
                                               moe_impl=self.moe_impl,
                                               pctx=pctx)
        self._next_rid = 0
        # static per-decoded-token energy of a spiking SSA stack (the
        # activity-independent ADC, periphery, LIF and comparator work);
        # none for any other stack, as in the reference
        self._e_token_pj = EM.lm_decode_token_energy_pj(
            cfg.d_model, cfg.num_heads, cfg.resolved_head_dim, cfg.d_ff,
            cfg.num_layers, cfg.spike_T, cache_len, cfg.vocab_size
        ) if self.spiking else 0.0
        self._e_event_pj = EM.decode_synapse_energy_pj()
        self.stats = ServeStats()
        # telemetry: host-side only (see repro_torch.obs)
        self.obs: Optional[Telemetry] = None
        self._stat_counters: Dict[str, Any] = {}
        self._stat_marks: Dict[str, float] = {}
        self._pool_marks: Dict[str, float] = {}
        self.set_params(params)
        self.reset()
        if obs is not None:
            self.attach_obs(obs)

    # -- telemetry -------------------------------------------------------

    # ServeStats fields mirrored into monotone counters (ServeStats stays
    # the one source of truth; the registry syncs by delta once a step)
    _STAT_COUNTERS = (
        ("decode_steps", "decode_steps_total",
         "batched decode_step invocations"),
        ("decoded_tokens", "decoded_tokens_total", "greedy tokens decoded"),
        ("prefill_tokens", "prefill_tokens_total",
         "prompt positions prefilled (chunked or batch-1)"),
        ("admissions", "admissions_total", "requests admitted into slots"),
        ("evictions", "evictions_total", "slot evictions (finish or preempt)"),
        ("spike_events", "spike_events_total",
         "measured residual-stream spike events"),
        ("energy_j", "energy_joules_total",
         "metered inference energy (spike events x op energies)"),
        ("recalibrations", "gdc_recalibrations_total",
         "GDC recalibrations run by the drift policy"),
        ("prefix_hits", "prefix_page_hits_total",
         "prefix-cache page hits across admissions"),
        ("prefix_hit_tokens", "prefix_hit_tokens_total",
         "prompt positions skipped via shared pages"),
        ("cow_copies", "cow_copies_total", "copy-on-write page duplications"),
    )

    def attach_obs(self, obs: Telemetry) -> None:
        """Install (or replace) the telemetry bundle: resolve metric
        handles once and arm the page-pool guard dump sites."""
        self.obs = obs
        m = obs.metrics
        self._h_step = m.histogram(
            "decode_step_seconds", "batched decode_step latency")
        self._g_active = m.gauge("active_slots", "slots holding a request")
        self._g_queue = m.gauge(
            "scheduler_queue_depth", "submitted-not-yet-admitted requests")
        self._g_clock = m.gauge(
            "device_clock_seconds", "PCM device clock (drift lifecycle)")
        self._g_gain = m.gauge(
            "gdc_gain_mean", "mean GDC gain across programmed crossbars "
            "(set at bind and after each recalibration)")
        self._g_pages_in_use = m.gauge(
            "pool_pages_in_use", "physical KV pages referenced")
        self._g_pages_free = m.gauge(
            "pool_pages_free", "physical KV pages on the free list")
        self._c_lookups = m.counter(
            "prefix_lookups_total", "prefix-cache block lookups",
            ("result",))
        self._stat_counters = {
            field: m.counter(name, help) for field, name, help in
            self._STAT_COUNTERS}
        self._stat_marks = {f: 0.0 for f, _, _ in self._STAT_COUNTERS}
        self._pool_marks = {"hit": 0.0, "miss": 0.0}
        self._g_clock.set(self._t_device)
        if self.programmed:
            self._g_gain.set(AD.gdc_gain_summary(self._state_params))
        if obs.profiler is not None:
            obs.profiler.cuda = self.device.type == "cuda"
        self._sync_stat_counters()
        self._arm_pool_guard()

    def detach_obs(self) -> None:
        """Remove the telemetry bundle (the inverse of :meth:`attach_obs`):
        metric handles are dropped, the page-pool guard hook is disarmed,
        and later runs book nothing.  The registry keeps its lifetime
        values; a re-attach mirrors the *current* ServeStats as fresh
        deltas, so :meth:`reset` between detach and re-attach to the same
        registry avoids booking the interlude twice."""
        self.obs = None
        self._stat_counters = {}
        self._stat_marks = {}
        if self.paged:
            self.pages.on_violation = None

    def _arm_pool_guard(self) -> None:
        if self.obs is not None and self.paged:
            self.pages.on_violation = self._on_guard

    def _on_guard(self, reason: str) -> None:
        """Invariant-guard dump site (page-pool double free / use after
        free, evict of an unoccupied slot): the postmortem first, then the
        raise proceeds."""
        if self.obs is not None:
            self.obs.guard_dump(reason)

    def _sync_stat_counters(self) -> None:
        """Mirror ServeStats into the registry's counters by delta."""
        st = self.stats
        marks = self._stat_marks
        for field, counter in self._stat_counters.items():
            cur = float(getattr(st, field))
            delta = cur - marks[field]
            if delta > 0:
                counter.inc(delta)
                marks[field] = cur

    def _obs_step(self, step_s: float) -> None:
        """Per-step telemetry: latency histogram, occupancy gauges,
        counter sync, pool stats, profiler window.  Python state only."""
        obs = self.obs
        if obs is None:
            return
        self._h_step.observe(step_s)
        self._g_active.set(sum(r is not None for r in self._slot_req))
        self._g_queue.set(len(self._queue))
        if self.paged:
            pool = self.pages
            self._g_pages_in_use.set(pool.in_use)
            self._g_pages_free.set(pool.free_pages)
            for result, cur in (("hit", pool.prefix_hits),
                                ("miss", pool.prefix_misses)):
                delta = cur - self._pool_marks[result]
                if delta > 0:
                    self._c_lookups.inc(delta, result)
                    self._pool_marks[result] = cur
        self._sync_stat_counters()
        if obs.profiler is not None:
            obs.profiler.tick()

    def _operands(self, tree: Any) -> Any:
        """The step's weight operands: a digital backend's quantised once
        (:func:`repro_torch.models.transformer.quantize_params`); the float
        reference backend reads the weights (and programmed state) as they
        are, as the reference's does; the float decode reads the weights
        as they are."""
        if not self.spiking or getattr(self.backend, "differentiable", False):
            return tree
        return T.quantize_params(tree, self.cfg)

    def set_params(self, params: Any) -> None:
        """Serve ``params`` (e.g. a newly programmed tree): place them on
        the device, derive the step's operands, and read the device clock
        from them (it picks up wherever the state already is: the device
        does not rejuvenate)."""
        self.source_params = params
        self._state_params = _to_device(params, self.device)
        self.params = self._operands(self._state_params)
        self.programmed = AD.has_device_state(params)
        self._t_device = AD.device_time(params)
        self._last_recal = self._t_device
        self._t_image = self._t_device  # device time of the last image fold
        self.stats.t_device_s = self._t_device

    def reset(self) -> None:
        """Drop all requests and state (a fresh server on the same params).
        The PCM device clock is not reset: drift is physical."""
        if self.paged:
            self.pages = PagePool(self.n_pages, self.page_len)
            self.state = ST.init_paged_state(self.cfg, len(self._own),
                                             self.cache_len, self.page_len,
                                             self.n_pages, self.device,
                                             self._kv_local)
            # host mirrors: page-table rows, per-slot logical positions,
            # prefill cursors, slot phases, outstanding page reservations,
            # prefix-cache chain ids
            self._table_rows = np.full((self.slots, self.max_pages),
                                       ST.NULL_PAGE, np.int32)
            self._slot_pos = [0] * self.slots
            self._cursor = [0] * self.slots
            self._phase = [DECODE] * self.slots
            self._slot_reserved = [0] * self.slots
            self._chain = [0] * self.slots
        else:
            self.state = ST.init_state(self.cfg, len(self._own),
                                       self.cache_len, self.device,
                                       self._kv_local)
        self._queue: Deque[Request] = deque()
        self._slot_req: List[Optional[Request]] = [None] * self.slots
        self._remaining: List[int] = [0] * self.slots
        self.outputs: Dict[int, List[int]] = {}
        # measured energy and spike events per request (rid -> totals)
        self.request_energy_j: Dict[int, float] = {}
        self.request_spikes: Dict[int, float] = {}
        self.stats = self._fresh_stats()
        if self.obs is not None:
            # counters are lifetime-monotone; only the delta marks rebase
            # onto the fresh ServeStats / PagePool
            self._stat_marks = {f: 0.0 for f, _, _ in self._STAT_COUNTERS}
            self._pool_marks = {"hit": 0.0, "miss": 0.0}
            self._arm_pool_guard()

    def _fresh_stats(self) -> ServeStats:
        st = ServeStats(t_device_s=self._t_device)
        if self.placement is not None:
            st.data_shards, st.model_shards = self.placement.mesh.shape
        return st

    def _local(self, slot: int) -> Optional[int]:
        """This rank's index of global ``slot``, ``None`` if another data
        rank holds it (every slot is local on one device)."""
        return slot - self._own.start if slot in self._own else None

    def _gather(self, x: torch.Tensor) -> np.ndarray:
        """Per-slot values of this rank's slots -> all slots' values on the
        host (a sum over the data group of zero-filled buffers: exact for
        the tokens and spike counts it carries)."""
        if self.placement is None:
            return x.cpu().numpy()
        mesh = self.placement.mesh
        buf = torch.zeros((self.slots,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=mesh.host_device)
        buf[self._own.start:self._own.stop] = x
        return mesh.all_reduce_data(buf).cpu().numpy()

    # -- request intake ------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new: int,
               seed: Optional[int] = None) -> int:
        """Queue a request; returns its rid.  ``seed`` (default: the rid)
        fixes the request's spike PRN stream."""
        p = np.asarray(prompt, np.int64).reshape(-1)
        if p.shape[0] < 1:
            raise ValueError("prompt must hold at least one token")
        if p.min() < 0 or p.max() >= self.cfg.vocab_size:
            # an out-of-range embedding gather would fault on the card
            raise ValueError(f"prompt tokens must lie in [0, "
                             f"{self.cfg.vocab_size})")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if p.shape[0] + max_new > self.cache_len:
            raise ValueError(
                f"prompt ({p.shape[0]}) + max_new ({max_new}) exceeds "
                f"cache_len ({self.cache_len})")
        if self.paged:
            worst = -(-(p.shape[0] - 1 + max_new) // self.page_len)
            usable = self.n_pages - ST.RESERVED_PAGES
            if worst > usable:
                raise ValueError(
                    f"request needs up to {worst} pages but the pool only "
                    f"has {usable} usable: it could never be admitted")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, p, max_new, rid if seed is None else int(seed),
                      ST.content_keys(p[:-1]))
        self._queue.append(req)
        self.stats.requests += 1
        if self.obs is not None:
            self.obs.trace(TR.SUBMIT, rid=rid, prompt_len=int(p.shape[0]),
                           max_new=max_new, seed=req.seed)
        return rid

    # -- slot management -----------------------------------------------

    def admit(self) -> int:
        """Admit queued requests into free slots; the other slots' state is
        untouched.  Dense: prefill batch-1 and splice.  Paged: reserve
        pages, resolve prefix-cache hits, and leave the remaining prompt
        positions to chunked prefill in the batched step.  Returns
        #admitted."""
        if self.paged:
            return self._admit_paged()
        admitted = 0
        for slot in range(self.slots):
            if not self._queue or self._slot_req[slot] is not None:
                continue
            req = self._queue.popleft()
            t0 = time.perf_counter()
            cache1 = T.init_cache(self.cfg, 1, self.cache_len, self.device,
                                  self._kv_local)
            ctx = torch.as_tensor(req.prompt[:-1], device=self.device)
            ckeys = torch.as_tensor(req.ckeys.astype(np.int64),
                                    device=self.device)
            cache1, act = self._prefill(self.params, ctx, ckeys, cache1)
            if self._local(slot) is not None:  # replicated over data
                ST.splice_request(self.state, self._local(slot), cache1,
                                  req.prompt[-1], req.seed)
            spikes = float(act)  # syncs the prefill
            self.stats.prefill_s += time.perf_counter() - t0
            self._slot_req[slot] = req
            self._remaining[slot] = req.max_new
            self.outputs[req.rid] = []
            # prefill energy depends on the prompt: its measured events and
            # the static cost of each context position, booked at admission
            e_j = (spikes * self._e_event_pj
                   + req.n_ctx * self._e_token_pj) * 1e-12
            self.request_spikes[req.rid] = (
                self.request_spikes.get(req.rid, 0.0) + spikes)
            self.request_energy_j[req.rid] = (
                self.request_energy_j.get(req.rid, 0.0) + e_j)
            self.stats.spike_events += spikes
            self.stats.energy_j += e_j
            self.stats.prefill_tokens += req.n_ctx
            self.stats.admissions += 1
            admitted += 1
            if self.obs is not None:
                self.obs.trace(TR.ADMIT, rid=req.rid, slot=slot,
                               prefill_tokens=req.n_ctx, mode="dense")
        self._note_occupancy()
        return admitted

    def _note_occupancy(self) -> None:
        self.stats.peak_active_slots = max(
            self.stats.peak_active_slots,
            sum(r is not None for r in self._slot_req))

    # -- paged-mode page plumbing --------------------------------------

    def _set_entry(self, slot: int, idx: int, pid: int) -> None:
        if self._local(slot) is not None:
            ST.paged_set_table_entry(self.state, self._local(slot), idx, pid)

    def _zero_freed(self, pids: List[int]) -> None:
        """Zero freed physical pages on the device."""
        if pids:
            ST.pool_zero_pages(self.state, pids)

    def _cow(self, slot: int, tp: int, src: int, keep_upto: int) -> int:
        """Copy-on-write: give ``slot`` sole ownership of logical block
        ``tp`` by copying the shared page's valid prefix (``< keep_upto``
        in-page positions) into a fresh page and repointing its table."""
        dst = self.pages.alloc(reserved=True)
        self._slot_reserved[slot] -= 1
        ST.pool_copy_page(self.state, src, dst, keep_upto)
        self._set_entry(slot, tp, dst)
        self._table_rows[slot, tp] = dst
        if self.pages.release(src):  # its cache entry may have been evicted
            self._zero_freed([src])
        self.pages.cow_copies += 1
        return dst

    def _register_prefix(self, slot: int, upto: int) -> None:
        """Publish the page holding context positions up to ``upto`` (the
        end of a just-completed block, or the whole context for a partial
        tail block) in the prefix cache, keyed by (parent chain id, the
        block's own tokens).  A tail block costs one reserved page later
        (the registrant's next write copies on write), so it is registered
        only when the pool has slack."""
        req = self._slot_req[slot]
        tp = (upto - 1) // self.page_len
        key = (self._chain[slot],
               tuple(req.prompt[tp * self.page_len:upto].tolist()))
        pid = int(self._table_rows[slot, tp])
        if pid == ST.NULL_PAGE:
            return
        if upto % self.page_len:  # partial tail block: a chain leaf
            if self.pages.prefix_contains(key) or self.pages.available() < 1:
                return
            self.pages.reserve(1)
            self._slot_reserved[slot] += 1
            self.pages.prefix_register(key, pid, chain=False)
            return
        # full block: adopt the (new or canonical) chain id so the slot's
        # next block links to it
        self._chain[slot] = self.pages.prefix_register(key, pid, chain=True)

    def _admit_paged(self) -> int:
        """Paged admission: exact-prefix page hits + worst-case page
        reservation.  First in first out: a request that cannot reserve
        its pages blocks the queue (head of line) rather than being
        overtaken, so admission order never depends on prompt sizes."""
        admitted = 0
        pl_ = self.page_len
        for slot in range(self.slots):
            if not self._queue or self._slot_req[slot] is not None:
                continue
            req = self._queue[0]
            ctx = req.prompt[:-1]
            n_ctx = req.n_ctx
            total_pages = -(-(n_ctx + req.max_new) // pl_)
            # leading-chain prefix match: full blocks while the chain is
            # unbroken, then (only off the complete full-block chain) the
            # partial tail leaf
            hits: List[int] = []
            chain = 0  # the empty-prefix root
            k = pl_
            while k <= n_ctx:
                ent = self.pages.prefix_lookup(
                    (chain, tuple(ctx[k - pl_:k].tolist())))
                if ent is None:
                    break
                hits.append(ent[0])
                chain = ent[1]
                k += pl_
            partial_pid = None
            if len(hits) == n_ctx // pl_ and n_ctx % pl_:
                ent = self.pages.prefix_lookup(
                    (chain, tuple(ctx[len(hits) * pl_:].tolist())))
                partial_pid = None if ent is None else ent[0]
            # worst-case unshared pages (a partial hit still allocates its
            # page at the copy-on-write); block on pool pressure
            needed = total_pages - len(hits)
            if self.pages.available() < needed:
                self._zero_freed(self.pages.prefix_evict(
                    needed - self.pages.available()))
            if self.pages.available() < needed:
                # hand the hit references back; the eviction above may have
                # dropped these pages' cache entries, in which case ours
                # was the last reference and the page is zeroed for reuse
                freed = [pid for pid in hits if self.pages.release(pid)]
                if partial_pid is not None and self.pages.release(partial_pid):
                    freed.append(partial_pid)
                self._zero_freed(freed)
                break
            self._queue.popleft()
            self.pages.reserve(needed)
            row = np.full((self.max_pages,), ST.NULL_PAGE, np.int32)
            row[:len(hits)] = hits
            cursor = len(hits) * pl_
            if partial_pid is not None:
                row[n_ctx // pl_] = partial_pid
                cursor = n_ctx
            self._table_rows[slot] = row
            if self._local(slot) is not None:
                ST.paged_admit_slot(self.state, self._local(slot), row,
                                    req.seed, cursor)
            self._slot_req[slot] = req
            self._remaining[slot] = req.max_new
            self._slot_pos[slot] = cursor
            self._cursor[slot] = cursor
            self._phase[slot] = PREFILL if cursor < n_ctx else HANDOFF
            self._slot_reserved[slot] = needed
            self._chain[slot] = chain  # registrations link after the hits
            self.outputs[req.rid] = []
            self.stats.prefix_hit_tokens += cursor
            self.stats.prefix_hits += len(hits) + (partial_pid is not None)
            self.stats.admissions += 1
            admitted += 1
            if self.obs is not None:
                self.obs.trace(TR.ADMIT, rid=req.rid, slot=slot, mode="paged",
                               prefix_hit_tokens=cursor,
                               reserved_pages=needed)
        self._note_occupancy()
        return admitted

    def free_slots(self) -> int:
        """Slots not holding a request (queued submissions are *not*
        counted: they claim a slot at the next ``step()``'s admission; see
        :meth:`queued_requests`)."""
        return sum(r is None for r in self._slot_req)

    def queued_requests(self) -> List[Request]:
        """Submitted-but-not-yet-admitted requests, first in first out
        (the front door reads this to budget the slots and pages it has
        already committed)."""
        return list(self._queue)

    def slot_of(self, rid: int) -> Optional[int]:
        """The slot decoding request ``rid`` (None when it is queued,
        finished or unknown)."""
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.rid == rid:
                return slot
        return None

    def preempt(self, rid: int) -> Request:
        """Take request ``rid`` out of the server -- release its slot (or
        drop it from the queue) and forget its collected output -- and
        return its :class:`Request`, so the caller decides when to submit
        it again.  The same (prompt, max_new, seed) decodes the same tokens
        again; energy already booked to ``rid`` stays booked."""
        slot = self.slot_of(rid)
        if slot is not None:
            req = self._slot_req[slot]
            if self.obs is not None:
                self.obs.trace(TR.PREEMPT, rid=rid, slot=slot,
                               streamed=len(self.outputs.get(rid, ())))
            self.evict(slot)
            self.outputs.pop(rid, None)
            return req
        for req in self._queue:
            if req.rid == rid:
                self._queue.remove(req)
                self.outputs.pop(rid, None)
                return req
        raise ValueError(f"preempt of unknown/finished request rid={rid}")

    def evict(self, slot: int, requeue: bool = False) -> None:
        """Release a slot's state.  With ``requeue=True`` the request
        restarts from its prompt on a later admission.  Evicting an
        unoccupied slot raises (after the telemetry's guard dump)."""
        req = self._slot_req[slot]
        if req is None:
            self._on_guard(f"evict of unoccupied slot {slot}")
            raise ValueError(f"evict of unoccupied slot {slot} "
                             "(double-evict or use-after-evict)")
        if self.obs is not None:
            self.obs.trace(TR.EVICT, rid=req.rid, slot=slot, requeue=requeue)
        if requeue:
            self._queue.appendleft(req)
            self.outputs.pop(req.rid, None)
        self._slot_req[slot] = None
        self._remaining[slot] = 0
        if self.paged:
            freed = [int(pid) for pid in self._table_rows[slot]
                     if pid != ST.NULL_PAGE and self.pages.release(int(pid))]
            self._zero_freed(freed)
            self.pages.unreserve(self._slot_reserved[slot])
            self._slot_reserved[slot] = 0
            self._table_rows[slot] = ST.NULL_PAGE
            self._slot_pos[slot] = 0
            self._cursor[slot] = 0
            self._phase[slot] = DECODE
            self._chain[slot] = 0
            if self._local(slot) is not None:
                ST.paged_release_slot(self.state, self._local(slot))
        elif self._local(slot) is not None:
            ST.release_slot(self.state, self._local(slot))
        self.stats.evictions += 1

    # -- serving loop --------------------------------------------------

    def _book_position(self, rid: int, spikes: float) -> None:
        """Book one served position's energy (measured spike events x the
        per-event energy, plus the static per-token cost) against its
        request and the stats: one formula for dense decode and paged
        decode and prompt positions."""
        e_j = (spikes * self._e_event_pj + self._e_token_pj) * 1e-12
        self.request_spikes[rid] = self.request_spikes.get(rid, 0.0) + spikes
        self.request_energy_j[rid] = (
            self.request_energy_j.get(rid, 0.0) + e_j)
        self.stats.spike_events += spikes
        self.stats.energy_j += e_j

    def step(self) -> int:
        """Admit, then advance every active slot one token (paged: one
        position, prompt or decode).  Returns the number of tokens decoded
        (0 when idle)."""
        if self.paged:
            return self._step_paged()
        self.admit()
        if not any(r is not None for r in self._slot_req):
            return 0
        t0 = time.perf_counter()
        _, self.state, act = self._decode(self.params, self.state)
        nxt = self._gather(self.state.tokens)  # syncs the step
        act = self._gather(act)
        step_s = time.perf_counter() - t0
        self.stats.decode_s += step_s
        self.stats.decode_steps += 1
        obs = self.obs
        decoded = 0
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is None:
                continue
            out = self.outputs[req.rid]
            out.append(int(nxt[slot]))
            decoded += 1
            if obs is not None:
                obs.trace(TR.FIRST_TOKEN if len(out) == 1 else TR.DECODE,
                          rid=req.rid, slot=slot, token=out[-1], pos=len(out))
            self._book_position(req.rid, float(act[slot]))
            self._remaining[slot] -= 1
            if self._remaining[slot] == 0:
                if obs is not None:
                    obs.trace(TR.FINISH, rid=req.rid, slot=slot,
                              tokens=len(out))
                self.evict(slot)
        self.stats.decoded_tokens += decoded
        self._advance_device_clock(step_s)
        self._obs_step(step_s)
        return decoded

    def _step_paged(self) -> int:
        """One paged batched step: chunked prefill and decode interleaved.

        Each occupied slot advances one position: a *prompt* position (the
        next context token on its content-keyed PRN stream), the admission
        handoff (the last prompt token on the request's own stream), or a
        decode position (greedy argmax riding the state).  Before the step
        every writing slot gets a page of its own for its target block
        (allocation at block boundaries, copy-on-write off shared pages);
        idle slots write the trash page.  Returns #tokens decoded (prompt
        positions don't count)."""
        self.admit()
        if not any(r is not None for r in self._slot_req):
            return 0
        b = self.slots
        # rows: feed token, feed seed, feed mask, write page
        feed = np.zeros((4, b), np.int64)
        feed[3] = ST.TRASH_PAGE
        for slot in range(b):
            req = self._slot_req[slot]
            if req is None:
                feed[2, slot] = 1  # pin idle slots to token 0 / stream 0
                continue
            tp, off = divmod(self._slot_pos[slot], self.page_len)
            pid = int(self._table_rows[slot, tp])
            if pid == ST.NULL_PAGE:  # block boundary: open a fresh page
                pid = self.pages.alloc(reserved=True)
                self._slot_reserved[slot] -= 1
                self._table_rows[slot, tp] = pid
                self._set_entry(slot, tp, pid)
            elif self.pages.refcount[pid] > 1:  # shared (prefix cache): CoW
                pid = self._cow(slot, tp, pid, off)
            feed[3, slot] = pid
            phase = self._phase[slot]
            if phase == PREFILL:
                cur = self._cursor[slot]
                feed[:3, slot] = (req.prompt[cur], int(req.ckeys[cur]), 1)
            elif phase == HANDOFF:
                feed[:3, slot] = (req.prompt[-1], req.seed & 0xFFFFFFFF, 1)
        t0 = time.perf_counter()
        own = slice(self._own.start, self._own.stop)
        tok, seed, mask, write_pids = torch.as_tensor(
            feed[:, own], device=self.device).unbind(0)
        _, self.state, act = self._decode(self.params, self.state, tok, seed,
                                          mask.bool(), write_pids)
        if self.placement is not None and self.placement.mesh.data > 1:
            offs = np.asarray(self._slot_pos) % self.page_len
            ST.exchange_page_writes(
                self.state, torch.as_tensor(feed[3], device=self.device),
                torch.as_tensor(offs, device=self.device), own,
                self.placement.mesh.all_reduce_data)
        nxt = self._gather(self.state.tokens)  # syncs the step
        act = self._gather(act)
        step_s = time.perf_counter() - t0
        self.stats.decode_s += step_s
        self.stats.decode_steps += 1
        obs = self.obs
        decoded = 0
        for slot in range(b):
            req = self._slot_req[slot]
            if req is None:
                continue
            self._slot_pos[slot] += 1
            phase = self._phase[slot]
            if phase == PREFILL:
                self._cursor[slot] += 1
                cur = self._cursor[slot]
                self.stats.prefill_tokens += 1
                if obs is not None:
                    obs.trace(TR.PREFILL_CHUNK, rid=req.rid, slot=slot,
                              pos=cur, n_ctx=req.n_ctx)
                if cur % self.page_len == 0:  # completed block: publish it
                    self._register_prefix(slot, cur)
                if cur == req.n_ctx:
                    if req.n_ctx % self.page_len:
                        self._register_prefix(slot, req.n_ctx)
                    self._phase[slot] = HANDOFF
            else:
                out = self.outputs[req.rid]
                out.append(int(nxt[slot]))
                decoded += 1
                if obs is not None:
                    obs.trace(TR.FIRST_TOKEN if len(out) == 1 else TR.DECODE,
                              rid=req.rid, slot=slot, token=out[-1],
                              pos=len(out))
                self._phase[slot] = DECODE
                self._remaining[slot] -= 1
            self._book_position(req.rid, float(act[slot]))
            if self._remaining[slot] == 0:
                if obs is not None:
                    obs.trace(TR.FINISH, rid=req.rid, slot=slot,
                              tokens=len(self.outputs[req.rid]))
                self.evict(slot)
        self.stats.decoded_tokens += decoded
        self.stats.pages_in_use_peak = max(self.stats.pages_in_use_peak,
                                           self.pages.peak_in_use)
        self.stats.cow_copies = self.pages.cow_copies
        self._advance_device_clock(step_s)
        self._obs_step(step_s)
        return decoded

    def _advance_device_clock(self, step_wall_s: float) -> None:
        """The drift lifecycle, per the :class:`~repro_torch.aimc_device.
        DriftPolicy`: advance the clock by one step; re-fold the image (K6,
        one launch per programmed leaf) once the drift factor has moved by
        half an int8 image step since the last fold, and always right
        before a GDC recalibration; recalibrate every ``recal_interval_s``.
        After a fold the step's operands are derived again, so no step
        serves a stale image."""
        pol = self.drift
        if pol is None or not self.programmed:
            return
        if pol.seconds_per_step <= 0 and self.placement is not None:
            # every rank folds at the same steps: rank 0's wall time
            step_wall_s = self.placement.mesh.broadcast_float(step_wall_s)
        dt = pol.seconds_per_step if pol.seconds_per_step > 0 else (
            step_wall_s * pol.time_scale)
        self._t_device += dt
        due_recal = (pol.recal_interval_s > 0 and
                     self._t_device - self._last_recal >= pol.recal_interval_s)
        # half an image step: (t / t_image) ** -nu_mean moved by 0.5 / 127
        ratio = (1.0 - 0.5 / 127.0) ** (-1.0 / max(pol.cfg.drift_nu_mean, 1e-3))
        due_image = self._t_device >= max(self._t_image,
                                          pol.cfg.drift_t0_s) * ratio
        if due_recal or due_image:
            tree = AD.drift_tree(self._state_params, self._t_device, pol.cfg)
            self._t_image = self._t_device
            self.stats.image_folds += 1
            if due_recal:
                tree = AD.recalibrate_tree(
                    tree, pol.cfg, None if self.placement is None
                    else self.placement.gdc_reduce)
                self._last_recal = self._t_device
                self.stats.recalibrations += 1
            self.source_params = self._state_params = tree
            self.params = self._operands(tree)
            if due_recal and self.obs is not None:
                # one host read a recalibration (rare): the gain after GDC
                # is the signal that it repaired the drift
                gain = AD.gdc_gain_summary(tree)
                self._g_gain.set(gain)
                self.obs.trace(TR.GDC_RECAL, t_device_s=self._t_device,
                               gain=gain, n=self.stats.recalibrations)
        self.stats.t_device_s = self._t_device
        if self.obs is not None:
            self._g_clock.set(self._t_device)

    def run(self) -> Dict[int, List[int]]:
        """Serve until the queue and all slots drain; returns outputs."""
        t0 = time.perf_counter()
        while self._queue or any(r is not None for r in self._slot_req):
            self.step()
        self.stats.wall_s += time.perf_counter() - t0
        if self.obs is not None and self.obs.profiler is not None:
            self.obs.profiler.stop()  # close a capture wider than the run
        return self.outputs


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, AD.AIMCDeviceState):
        return tree.map(lambda x: x.to(device))
    return tree.to(device)
