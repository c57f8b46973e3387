"""Async serving front door over :class:`repro_torch.serving.BatchScheduler`.

Twin of ``repro/server/frontdoor.py``.  The :class:`FrontDoor` is the
admission layer between transport (HTTP/SSE, :mod:`repro_torch.server.
http`, or an in-process caller) and the synchronous continuous-batching
scheduler:

* requests arrive on the event loop (:meth:`FrontDoor.submit`) and are
  queued per tenant;
* one **pump** iteration at a time runs in the front door's own worker
  thread -- it applies the :class:`~repro_torch.server.admission.
  AdmissionController`'s decisions (priority + token-fairness pick,
  energy throttling, preemption, :class:`~repro_torch.serving.pages.
  PagePool` backpressure), feeds the scheduler, runs one batched step, and
  streams freshly decoded tokens back to per-request
  :class:`asyncio.Queue`\\ s;
* the scheduler is only ever touched from that one thread, which runs
  every pump under ``torch.no_grad()`` and on the scheduler's CUDA device
  (grad mode and the current device are per thread in PyTorch), so the
  async layer adds **no nondeterminism to token values**: each request's
  stream is the scheduler's pure f(params, prompt, seed) token sequence,
  independent of arrival interleaving, batching, throttling or
  preemption.

**Preemption / re-admission.**  When a tenant overruns its joule bucket
mid-flight, its running requests are evicted
(:meth:`repro_torch.serving.BatchScheduler.preempt`) and parked back at
the head of the tenant queue.  On re-admission the request is
*resubmitted from its prompt with the same seed*: purity regenerates the
identical token prefix, the front door replays it silently (checking
bit-equality with what was already streamed) and the client stream
resumes where it left off.  The replayed decode's extra joules are charged
to the tenant: preemption is not free, and the meter says what it cost.

**Over a mesh** the scheduler is rank 0's wrapped in a
:class:`repro_torch.server.mesh.MeshLeader`: an idle pump round calls its
``heartbeat`` and the pump's end its ``close``, which keep the other
ranks' followers inside their process groups' timeout and end them.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs import Telemetry
from repro_torch.obs import trace as TR
from repro_torch.server import admission as ADM
from repro_torch.server.admission import AdmissionController, TenantPolicy
from repro_torch.serving.state import RESERVED_PAGES

PENDING, RUNNING, DONE, FAILED = "pending", "running", "done", "failed"

# all front-door interval math runs on the monotonic clock: TTFT, latency,
# token gaps and bucket-refill deltas must never jump with NTP/wall-clock
# slew.  Wall-clock time.time() survives only where an *epoch timestamp*
# is wanted (trace events stamp both, see repro_torch.obs.trace).
_now = time.perf_counter


class QueueFull(RuntimeError):
    """The front door's pending queue is at capacity (HTTP 429)."""


@dataclasses.dataclass
class RequestResult:
    """Terminal record for one request, attached to its stream."""

    request_id: int
    tenant: str
    tokens: List[int]
    energy_j: float  # metered joules booked to this request (replays incl.)
    ttft_s: float  # submit -> first streamed token
    latency_s: float  # submit -> last token
    preemptions: int
    token_times: List[float]  # monotonic stamp each token was streamed


@dataclasses.dataclass
class _FrontRequest:
    fid: int
    tenant: str
    prompt: np.ndarray
    max_new: int
    seed: int
    q: "asyncio.Queue[Optional[int]]"
    state: str = PENDING
    rid: Optional[int] = None  # current scheduler rid (changes on preempt)
    served: int = 0  # tokens of the CURRENT rid's output processed
    streamed: int = 0  # tokens actually delivered to the client
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_times: List[float] = dataclasses.field(default_factory=list)
    energy_j: float = 0.0
    charged_j: float = 0.0  # energy booked for the current rid so far
    preemptions: int = 0
    new_since_admit: int = 0  # NEW tokens streamed in this admission streak
    last_defer: str = ""  # dedup tag so defer records log transitions only
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    result: Optional[RequestResult] = None
    error: Optional[str] = None


class TokenStream:
    """Async iterator over one request's generated token ids."""

    def __init__(self, req: _FrontRequest):
        self._req = req

    @property
    def request_id(self) -> int:
        return self._req.fid

    @property
    def result(self) -> Optional[RequestResult]:
        """The terminal :class:`RequestResult` (None until the stream ends)."""
        return self._req.result

    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        tok = await self._req.q.get()
        if tok is None:
            if self._req.error:
                raise RuntimeError(self._req.error)
            raise StopAsyncIteration
        return tok

    async def tokens(self) -> List[int]:
        """Drain the stream to completion and return all token ids."""
        return [t async for t in self]


class FrontDoor:
    """Asyncio admission layer feeding one :class:`BatchScheduler`.

    ``policies`` maps tenant name -> :class:`TenantPolicy` (unknown tenants
    get ``default_policy``).  ``max_queue`` bounds pending requests across
    all tenants — beyond it :meth:`submit` raises :class:`QueueFull`
    (HTTP 429), the load-shedding backstop above the PagePool/slot
    backpressure that merely *defers*.
    """

    def __init__(
        self,
        scheduler,
        *,
        policies: Optional[Dict[str, TenantPolicy]] = None,
        default_policy: Optional[TenantPolicy] = None,
        max_queue: int = 256,
        idle_s: float = 0.002,
        telemetry: Optional[Telemetry] = None,
        enable_telemetry: bool = True,
    ):
        self.sch = scheduler
        self.adm = AdmissionController(policies, default_policy)
        self.max_queue = max_queue
        self.idle_s = idle_s
        # one Telemetry bundle spans the whole stack: the scheduler's if it
        # already has one, else ``telemetry``, else a fresh default bundle
        # (enable_telemetry=False opts out entirely: the baseline of a
        # telemetry-overhead measurement)
        self.obs: Optional[Telemetry] = None
        if enable_telemetry:
            self.obs = (getattr(scheduler, "obs", None) or telemetry
                        or Telemetry.create())
            if getattr(scheduler, "obs", None) is None:
                scheduler.attach_obs(self.obs)
            self.adm.bind_metrics(self.obs.metrics)
            m = self.obs.metrics
            self._h_ttft = m.histogram(
                "ttft_seconds", "submit to first streamed token")
            self._h_tpot = m.histogram(
                "tpot_seconds", "gap between consecutive streamed tokens")
            self._g_pending = m.gauge(
                "frontdoor_queue_depth", "requests pending admission")
            self._g_running = m.gauge(
                "frontdoor_running", "requests holding a scheduler slot")
            self._c_requests = m.counter(
                "frontdoor_requests_total", "terminal request outcomes",
                ("outcome",))
            self._c_preempt = m.counter(
                "frontdoor_preemptions_total", "energy-SLO preemptions")
            self._g_credit = m.gauge(
                "tenant_energy_credit_joules",
                "joule token-bucket level per metered tenant", ("tenant",))
        self._intake: Deque[_FrontRequest] = deque()  # loop -> pump handoff
        self._pending: Dict[str, Deque[_FrontRequest]] = {}
        self._running: Dict[int, _FrontRequest] = {}  # scheduler rid -> req
        # streams a pump round ended: signalled only once the round has set
        # its gauges, so a client that saw its end reads them up to date
        self._ended: List[_FrontRequest] = []
        self._requests: Dict[int, _FrontRequest] = {}  # fid -> req (all)
        self._results: List[RequestResult] = []
        self._next_fid = 0
        self._pending_count = 0  # intake + per-tenant queues (loop-side gate)
        self._last_refill = _now()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._task: Optional[asyncio.Task] = None
        self._pool: Optional[ThreadPoolExecutor] = None  # the pump thread
        self._stopping = False
        self._lock = threading.Lock()  # guards _pending_count across threads
        self.completed = 0
        self.failed = 0
        self.preemptions = 0

    # -- event-loop side ------------------------------------------------

    async def start(self) -> None:
        assert self._task is None, "front door already started"
        self._loop = asyncio.get_running_loop()
        self._stopping = False
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="xpike-pump")
        self._task = self._loop.create_task(self._run())

    async def stop(self) -> None:
        """Stop the pump; outstanding streams are failed with 'shutdown'.
        A profiler window the pump opened and the run did not fill is
        closed, and its trace written, in the pump thread, where
        ``torch.profiler`` requires it."""
        self._stopping = True
        if self._task is not None:
            try:
                await self._task
            finally:
                self._task = None
                prof = self.obs.profiler if self.obs is not None else None
                try:
                    if prof is not None:
                        await self._loop.run_in_executor(self._pool,
                                                         prof.stop)
                finally:
                    self._pool.shutdown(wait=True)
                    self._pool = None

    async def wait(self) -> None:
        """Until the pump ends: after :meth:`stop`, or when it raised
        (:meth:`stop` then raises its exception)."""
        if self._task is not None:
            await asyncio.wait([self._task])

    async def submit(self, prompt: Sequence[int], max_new: int, *,
                     seed: Optional[int] = None,
                     tenant: str = "default") -> TokenStream:
        """Queue a request; returns its :class:`TokenStream`.

        ``seed`` fixes the request's spike-PRN stream (defaults to the
        front-door request id) — the same (prompt, seed) streams the same
        tokens no matter how admission interleaves it.  Raises
        :class:`ValueError` on an unservable request (bad shape, exceeds
        ``cache_len`` or the page pool, a token outside the vocabulary) and
        :class:`QueueFull` at capacity.
        """
        prompt_np = np.asarray(list(prompt), np.int64)
        if prompt_np.ndim != 1 or prompt_np.shape[0] < 1:
            raise ValueError("prompt must be a non-empty 1-D token list")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        sch = self.sch
        vocab = sch.cfg.vocab_size
        if prompt_np.min() < 0 or prompt_np.max() >= vocab:
            # the scheduler refuses it too, but in the pump thread
            raise ValueError(f"prompt tokens must lie in [0, {vocab})")
        if prompt_np.shape[0] + max_new > sch.cache_len:
            raise ValueError(
                f"prompt ({prompt_np.shape[0]}) + max_new ({max_new}) "
                f"exceeds cache_len ({sch.cache_len})")
        if sch.paged:
            worst = self._worst_pages(prompt_np.shape[0], max_new)
            usable = sch.n_pages - self._reserved_pages()
            if worst > usable:
                raise ValueError(
                    f"request needs up to {worst} pages but the pool only "
                    f"has {usable} usable — it could never be admitted")
        with self._lock:
            if self._pending_count >= self.max_queue:
                fid = self._next_fid  # not consumed: the request is shed
                self.adm.record(fid, tenant, ADM.DEFER_QUEUE,
                                f"pending={self._pending_count}")
                raise QueueFull(
                    f"{self._pending_count} requests pending (max_queue="
                    f"{self.max_queue})")
            fid = self._next_fid
            self._next_fid += 1
            self._pending_count += 1
        req = _FrontRequest(
            fid=fid, tenant=tenant, prompt=prompt_np, max_new=max_new,
            seed=fid if seed is None else seed, q=asyncio.Queue())
        req.t_submit = _now()
        self._requests[fid] = req
        self._intake.append(req)
        if self.obs is not None:
            self.obs.trace(TR.SUBMIT, fid=fid, tenant=tenant,
                           prompt_len=int(prompt_np.shape[0]),
                           max_new=max_new)
        return TokenStream(req)

    # -- introspection --------------------------------------------------

    @property
    def results(self) -> List[RequestResult]:
        return list(self._results)

    def stats_dict(self) -> Dict[str, Any]:
        """Aggregate serving stats for ``GET /stats``: scheduler
        :class:`~repro_torch.serving.ServeStats` + front-door admission
        state."""
        st = self.sch.stats
        sched = {f.name: getattr(st, f.name)
                 for f in dataclasses.fields(st)}
        sched["tokens_per_sec"] = st.tokens_per_sec
        sched["j_per_token"] = st.j_per_token
        tenants = {
            name: {
                "priority": t.policy.priority,
                "weight": t.policy.weight,
                "energy_budget_j": t.policy.energy_budget_j,
                "credit_j": (None if t.policy.energy_budget_j is None
                             else t.credit_j),
                "spent_j": t.spent_j,
                "spent_tokens": t.spent_tokens,
                "inflight": t.inflight,
            }
            for name, t in list(self.adm.tenants.items())
        }
        out = {
            "scheduler": sched,
            "tenants": tenants,
            "pending": self._pending_count,
            "running": len(self._running),
            "completed": self.completed,
            "failed": self.failed,
            "preemptions": self.preemptions,
            "decisions": [dataclasses.asdict(r)
                          for r in list(self.adm.records)[-64:]],
        }
        if self.obs is not None:
            # the full registry snapshot nests under "metrics" — the same
            # families GET /metrics exposes, as structured JSON
            out["metrics"] = self.obs.metrics.snapshot()
        return out

    # -- pump (worker thread) -------------------------------------------

    async def _run(self) -> None:
        loop = self._loop
        try:
            while not self._stopping:
                busy = await loop.run_in_executor(self._pool, self._pump_once)
                await asyncio.sleep(0 if busy else self.idle_s)
        except BaseException as e:
            # a pump that raised ends every open stream (the exception
            # surfaces at stop()) instead of leaving the clients waiting
            self._shutdown_flush(f"front door pump failed: {e!r}")
            raise
        self._shutdown_flush("front door shutdown")

    def _shutdown_flush(self, reason: str) -> None:
        for req in self._requests.values():
            if req.state in (PENDING, RUNNING):
                req.error = reason
                req.state = FAILED
                self.failed += 1
                self._finish_signal(req)
        # a mesh's leader (repro_torch.server.mesh) stops its followers
        # after the last step
        close = getattr(self.sch, "close", None)
        if close is not None:
            close()

    def _finish_signal(self, req: _FrontRequest) -> None:
        self._loop.call_soon_threadsafe(req.q.put_nowait, None)

    def _push_token(self, req: _FrontRequest, tok: int) -> None:
        self._loop.call_soon_threadsafe(req.q.put_nowait, tok)

    def _worst_pages(self, prompt_len: int, max_new: int) -> int:
        return -(-(prompt_len - 1 + max_new) // self.sch.page_len)

    def _reserved_pages(self) -> int:
        return RESERVED_PAGES

    def _tenant_queue(self, name: str) -> Deque[_FrontRequest]:
        q = self._pending.get(name)
        if q is None:
            q = self._pending[name] = deque()
        return q

    def _pump_once(self) -> bool:
        """One admission + decode + streaming round, in the pump thread:
        without autograd and on the scheduler's CUDA device, whatever the
        thread's own state.  Returns True when any work happened (intake,
        admission, a decode step, streamed tokens)."""
        dev = self.sch.device
        on_dev = (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext())
        with torch.no_grad(), on_dev:
            return self._pump()

    def _pump(self) -> bool:
        try:
            return self._pump_round()
        finally:
            ended, self._ended = self._ended, []
            for req in ended:
                self._finish_signal(req)

    def _pump_round(self) -> bool:
        busy = False
        now = _now()
        self.adm.refill(now - self._last_refill)
        self._last_refill = now
        # 1. drain the loop->pump intake into per-tenant FIFO queues
        while self._intake:
            req = self._intake.popleft()
            self._tenant_queue(req.tenant).append(req)
            busy = True
        # 2. energy preemption: evict running requests of over-budget
        #    tenants; they park at the head of their tenant queue and
        #    re-admit (bit-exact resume) once the bucket refills
        for rid in [r for r in self._running]:
            req = self._running[rid]
            # liveness guard: a running request may only be preempted after
            # it streamed >= 1 NEW token in this admission streak.  Without
            # it, a joule bucket smaller than the restart cost (prefill +
            # replay of already-streamed tokens) livelocks the request —
            # preempted at the exact replay boundary forever, all burn and
            # no progress.  With it every streak advances the stream.
            if req.new_since_admit < 1:
                continue
            if self.adm.should_preempt(req.tenant):
                self.sch.preempt(rid)
                del self._running[rid]
                self.adm.tenant(req.tenant).inflight -= 1
                req.rid = None
                req.served = 0
                req.charged_j = 0.0
                req.state = PENDING
                req.preemptions += 1
                self.preemptions += 1
                req.last_defer = ADM.DEFER_ENERGY
                self.adm.record(req.fid, req.tenant, ADM.PREEMPT_ENERGY,
                                f"credit={self.adm.tenant(req.tenant).credit_j:.3e}J "
                                f"streamed={req.streamed}")
                if self.obs is not None:
                    self._c_preempt.inc()
                    self.obs.trace(TR.PREEMPT, fid=req.fid, rid=rid,
                                   tenant=req.tenant, streamed=req.streamed)
                # pending again: its re-admission takes it off the count
                # (the reference leaves it out, and its queue depth reads
                # minus the preemptions once the queues drain)
                with self._lock:
                    self._pending_count += 1
                self._tenant_queue(req.tenant).appendleft(req)
                busy = True
        # 3. admission: strict priority + token fairness, energy throttle,
        #    slot/page backpressure (decisions recorded on transitions)
        busy |= self._admit()
        # 4. one batched decode step
        if self._running:
            self.sch.step()
            busy = True
            self._stream_new_tokens()
        if self.obs is not None:
            self._g_pending.set(float(self._pending_count))
            self._g_running.set(float(len(self._running)))
            for name, st in list(self.adm.tenants.items()):
                if st.policy.energy_budget_j is not None:
                    self._g_credit.set(st.credit_j, name)
        if not busy:
            # a mesh's leader keeps its waiting followers inside their
            # process group's timeout
            heartbeat = getattr(self.sch, "heartbeat", None)
            if heartbeat is not None:
                heartbeat()
        return busy

    def _admit(self) -> bool:
        sch, adm = self.sch, self.adm
        admitted = False
        # the scheduler only claims slots/pages at the next step()'s own
        # admission, so budget locally for what is already committed —
        # free slots minus its queue, free pages minus the queue's worst case
        backlog = sch.queued_requests()
        free = sch.free_slots() - len(backlog)
        pages_free = 0
        if sch.paged:
            pages_free = sch.pages.available() - sum(
                self._worst_pages(len(r.prompt), r.max_new)
                for r in backlog)
        while True:
            queued = [t for t, q in self._pending.items() if q]
            if not queued:
                break
            if free <= 0:
                self._record_defer(queued, ADM.DEFER_SLOTS,
                                   f"slots={sch.slots}")
                break
            name = adm.pick(queued)
            if name is None:  # every queued tenant is energy-throttled
                self._record_defer(
                    [t for t in queued if not adm.tenant(t).energy_ok],
                    ADM.DEFER_ENERGY, "bucket empty")
                break
            req = self._pending[name][0]
            worst = 0
            if sch.paged:
                worst = self._worst_pages(len(req.prompt), req.max_new)
                if pages_free < worst:
                    # PagePool backpressure: hold the line until running
                    # requests release pages (head-of-line, no overtaking —
                    # admission order must not depend on request size)
                    self._record_defer([name], ADM.DEFER_PAGES,
                                       f"need={worst} free={pages_free}")
                    break
            self._pending[name].popleft()
            with self._lock:
                self._pending_count -= 1
            rid = sch.submit(req.prompt, req.max_new, seed=req.seed)
            free -= 1
            pages_free -= worst
            req.rid = rid
            req.served = 0
            req.new_since_admit = 0
            req.charged_j = 0.0
            req.state = RUNNING
            req.last_defer = ""
            self._running[rid] = req
            adm.tenant(name).inflight += 1
            decision = ADM.READMIT if req.preemptions else ADM.ADMIT
            adm.record(req.fid, name, decision, f"rid={rid}")
            if self.obs is not None:
                self.obs.trace(
                    TR.READMIT if req.preemptions else TR.ADMIT,
                    fid=req.fid, rid=rid, tenant=name)
            admitted = True
        return admitted

    def _record_defer(self, tenants: List[str], reason: str, detail: str) -> None:
        """Record a defer for each named tenant's head request, once per
        reason transition (so records log state changes, not every pump)."""
        for name in tenants:
            q = self._pending.get(name)
            if not q:
                continue
            head = q[0]
            if head.last_defer != reason:
                head.last_defer = reason
                self.adm.record(head.fid, name, reason, detail)

    def _stream_new_tokens(self) -> None:
        sch = self.sch
        now = _now()
        done: List[int] = []
        for rid, req in self._running.items():
            # energy: charge this rid's delta to the tenant bucket
            booked = sch.request_energy_j.get(rid, 0.0)
            delta = booked - req.charged_j
            if delta > 0:
                req.charged_j = booked
                req.energy_j += delta
                self.adm.charge(req.tenant, delta)
            out = sch.outputs.get(rid, [])
            new_tokens = 0
            while req.served < len(out):
                tok = int(out[req.served])
                if req.served < req.streamed:
                    # replay after preemption: purity must regenerate the
                    # already-streamed prefix bit-exactly
                    if tok != req.tokens[req.served]:
                        req.error = (
                            f"preemption replay diverged at token "
                            f"{req.served}: {tok} != {req.tokens[req.served]}")
                        req.state = FAILED
                        done.append(rid)
                        break
                else:
                    if req.t_first is None:
                        req.t_first = now
                        if self.obs is not None:
                            self._h_ttft.observe(now - req.t_submit)
                            self.obs.trace(TR.FIRST_TOKEN, fid=req.fid,
                                           rid=rid, tenant=req.tenant,
                                           ttft_s=now - req.t_submit)
                    elif self.obs is not None and req.token_times:
                        gap = now - req.token_times[-1]
                        if gap > 0:  # same-step tokens share one stamp
                            self._h_tpot.observe(gap)
                    req.tokens.append(tok)
                    req.token_times.append(now)
                    req.streamed += 1
                    req.new_since_admit += 1
                    new_tokens += 1
                    self._push_token(req, tok)
                req.served += 1
            if new_tokens:
                self.adm.charge(req.tenant, 0.0, tokens=new_tokens)
            if req.state != FAILED and req.streamed >= req.max_new:
                req.state = DONE
                done.append(rid)
        for rid in done:
            req = self._running.pop(rid)
            self.adm.tenant(req.tenant).inflight -= 1
            if req.state == FAILED:
                if self.sch.slot_of(rid) is not None:
                    self.sch.preempt(rid)
                self.failed += 1
                if self.obs is not None:
                    self._c_requests.inc(1.0, "failed")
                    self.obs.trace(TR.FINISH, fid=req.fid, rid=rid,
                                   tenant=req.tenant, outcome="failed",
                                   error=req.error)
                self._ended.append(req)
                continue
            req.t_done = now
            if self.obs is not None:
                self._c_requests.inc(1.0, "completed")
                self.obs.trace(TR.FINISH, fid=req.fid, rid=rid,
                               tenant=req.tenant, outcome="completed",
                               tokens=req.streamed,
                               latency_s=now - req.t_submit,
                               energy_j=req.energy_j)
            req.result = RequestResult(
                request_id=req.fid, tenant=req.tenant, tokens=list(req.tokens),
                energy_j=req.energy_j,
                ttft_s=(req.t_first or now) - req.t_submit,
                latency_s=now - req.t_submit,
                preemptions=req.preemptions,
                token_times=list(req.token_times),
            )
            self._results.append(req.result)
            self.completed += 1
            self._ended.append(req)
