"""The port's serving front door (``repro_torch.server``) on the CPU.

* **Differential**: the port's ``HttpFrontDoor`` SSE streams, over real
  sockets, equal JAX's direct ``BatchScheduler`` (``IntegerBackend``)
  tokens for the same params, prompts and seeds, dense and paged.
* **Policy**: ``AdmissionController`` decision records and tenant states
  equal JAX's on the same scripted submissions, charges, grants and
  refills -- alone, and driven through both ``FrontDoor`` pumps over the
  same scripted scheduler.
* The cases of ``tests/test_server.py`` on the port: stats and errors with
  the same status codes, a live metrics scrape, energy deferral,
  preemption re-admitted bit-exact, page backpressure, queue-full
  shedding, submit validation, priority before fairness.
* A front door over a float ``reference``-backend scheduler whose params
  require gradients builds no autograd graph (its pump thread runs
  without grad).

The scheduler runs the plain versions of the kernels (``device="cpu"``),
on the reduced ``xpikeformer-gpt-4-256``.
"""

import asyncio
import json
import time
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.engine import IntegerBackend as JIntegerBackend
from repro.models import transformer as JT
from repro.server import FrontDoor as JFrontDoor
from repro.server import admission as JADM
from repro.serving import BatchScheduler as JBatchScheduler
from repro_torch import convert
from repro_torch.configs import registry as R
from repro_torch.engine import get_backend
from repro_torch.obs import render_prometheus
from repro_torch.server import (FrontDoor, HttpFrontDoor, QueueFull,
                                TenantPolicy, read_sse)
from repro_torch.server import admission as ADM
from repro_torch.serving import BatchScheduler, ServeStats

ARCH = "xpikeformer-gpt-4-256"
DENSE = dict(slots=2, cache_len=32)
PAGED = dict(slots=3, cache_len=32, paged=True, page_len=8, n_pages=8)


def _prompt(i, length=5):
    return list(range(3 + i, 3 + i + length))


# (prompt, max_new, seed) jobs of each test, and the layout they run on;
# every prompt is 5 tokens, so JAX compiles one prefill
JOBS = {
    "dense": ("dense", [(_prompt(i), 4 + (i % 2), 20 + i) for i in range(4)]),
    "paged": ("paged", [(_prompt(i), 4, 40 + i) for i in range(3)]),
    "scrape": ("paged", [(_prompt(i), 4, 50 + i) for i in range(2)]),
    "defer": ("dense", [(_prompt(0), 4, 91)]),
    "preempt": ("dense", [(_prompt(1), 6, 77)]),
    # ceil((5 - 1 + 13) / 8) = 3 pages each of 6 usable: two requests take
    # the pages while the third slot is free
    "pages": ("paged", [(_prompt(i), 13, 60 + i) for i in range(3)]),
}


def _direct(sch, jobs):
    """Tokens and metered joules of each job, served directly."""
    sch.reset()
    rids = [sch.submit(p, mn, seed=s) for p, mn, s in jobs]
    outs = sch.run()
    return ([list(outs[r]) for r in rids],
            [float(sch.request_energy_j[r]) for r in rids])


@pytest.fixture(scope="module")
def setup():
    """Params carried across, and JAX's direct tokens and joules of every
    test's jobs (one JAX scheduler a layout, built once)."""
    cfg = JR.reduced_config(ARCH)
    jparams = JT.init_params(jax.random.PRNGKey(0), cfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    jsch = {"dense": JBatchScheduler(jparams, cfg, JIntegerBackend(), **DENSE),
            "paged": JBatchScheduler(jparams, cfg, JIntegerBackend(), **PAGED)}
    want = {name: _direct(jsch[layout], jobs)
            for name, (layout, jobs) in JOBS.items()}
    return R.reduced_config(ARCH), tparams, want


@pytest.fixture(scope="module")
def dense_sched(setup):
    tcfg, tparams, _ = setup
    return BatchScheduler(tparams, tcfg, "integer", device="cpu", **DENSE)


@pytest.fixture(scope="module")
def paged_sched(setup):
    tcfg, tparams, _ = setup
    return BatchScheduler(tparams, tcfg, "integer", device="cpu", **PAGED)


# -- differential: HTTP/SSE == JAX's direct scheduler -------------------------


async def _sse_generate(host, port, prompt, max_new, seed, tenant=None):
    """POST /generate over a real socket; returns (token list, done dict)."""
    req = {"prompt": prompt, "max_new": max_new, "seed": seed}
    if tenant is not None:
        req["tenant"] = tenant
    body = json.dumps(req).encode()
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(
            (f"POST /generate HTTP/1.1\r\nHost: {host}\r\n"
             f"Content-Type: application/json\r\n"
             f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        await writer.drain()
        toks, done = [], None
        async for ev, payload in read_sse(reader):
            if ev == "token":
                assert payload["index"] == len(toks)  # in order, gapless
                toks.append(payload["token"])
            elif ev == "done":
                done = payload
        return toks, done
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def _raw(host, port, req: bytes) -> bytes:
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(req)
    await writer.drain()
    data = await reader.read()
    writer.close()
    return data


def _status(data: bytes) -> bytes:
    return data.split(b"\r\n", 1)[0]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_http_sse_matches_jax_direct(setup, dense_sched, paged_sched, layout):
    """Concurrent SSE streams over fewer slots (paged: fewer pages) equal
    JAX's direct scheduler token for token."""
    _, _, want = setup
    sch = dense_sched if layout == "dense" else paged_sched
    jobs = JOBS[layout][1]
    sch.reset()

    async def go():
        async with HttpFrontDoor(FrontDoor(sch), port=0) as srv:
            return await asyncio.gather(*(
                _sse_generate(srv.host, srv.port, p, mn, s)
                for p, mn, s in jobs))

    got = asyncio.run(go())
    for (toks, done), want_toks, want_j in zip(got, *want[layout]):
        assert toks == want_toks
        assert done is not None and done["tokens"] == want_toks
        assert done["ttft_s"] >= 0 and done["latency_s"] >= done["ttft_s"]
        assert done["energy_j"] == pytest.approx(want_j, rel=1e-12)
        assert done["preemptions"] == 0


# -- admission policy: the same records as the reference ---------------------


def _script(mod):
    """A scripted sequence of tenants, picks, charges, grants and refills
    on ``mod``'s AdmissionController; returns its records and states."""
    adm = mod.AdmissionController(
        {"gold": mod.TenantPolicy(priority=0, weight=2.0),
         "meter": mod.TenantPolicy(priority=1, energy_budget_j=1.0,
                                   refill_j_per_s=0.5),
         "soft": mod.TenantPolicy(priority=1, energy_budget_j=2.0,
                                  preempt=False)},
        default=mod.TenantPolicy(priority=1, weight=0.5), max_records=16)
    picks = []
    for step in range(12):
        queued = ["meter", "soft", "anon", "gold"][step % 4:] + ["anon"]
        name = adm.pick(queued)
        picks.append(name)
        if name is not None:
            adm.record(step, name, mod.ADMIT if step % 3 else mod.READMIT,
                       f"rid={step}")
            adm.charge(name, 0.375 * (step % 5), tokens=step % 4)
        if adm.should_preempt("meter"):
            adm.record(step, "meter", mod.PREEMPT_ENERGY, "credit<=0")
        adm.refill(0.25 * (step % 3))
        if step == 6:
            adm.grant("soft", 5.0)
            adm.set_policy("meter", mod.TenantPolicy(
                priority=1, energy_budget_j=0.75, refill_j_per_s=0.25))
        adm.record(step, "anon", mod.DEFER_SLOTS, "slots=2")
    states = {n: (t.credit_j, t.spent_j, t.spent_tokens, t.inflight,
                  t.energy_ok, t.fair_share_key)
              for n, t in adm.tenants.items()}
    return picks, [tuple(vars(r).values()) for r in adm.records], states


def test_admission_records_equal_jax():
    assert _script(ADM) == _script(JADM)
    assert [getattr(ADM, k) for k in ("ADMIT", "READMIT", "DEFER_ENERGY",
                                      "DEFER_SLOTS", "DEFER_PAGES",
                                      "DEFER_QUEUE", "PREEMPT_ENERGY")] == [
        getattr(JADM, k) for k in ("ADMIT", "READMIT", "DEFER_ENERGY",
                                   "DEFER_SLOTS", "DEFER_PAGES", "DEFER_QUEUE",
                                   "PREEMPT_ENERGY")]


class _ScriptedScheduler:
    """A scheduler stand-in with the front door's interface: each step
    admits FIFO into free slots and gives every running request one token,
    ``(seed * 31 + len(out) * 7) % 64``, and 0.25 J (plus 0.125 J a prompt
    token at admission).  Paged: a request reserves its worst-case pages."""

    def __init__(self, slots=2, cache_len=32, paged=False, page_len=8,
                 n_pages=8):
        self.slots, self.cache_len, self.paged = slots, cache_len, paged
        self.page_len, self.n_pages = page_len, n_pages
        self.cfg = types.SimpleNamespace(vocab_size=64)
        self.device = torch.device("cpu")
        self.obs = None
        self.stats = ServeStats()  # read by GET /stats only
        self._queue, self._slot = [], [None] * slots
        self.outputs, self.request_energy_j = {}, {}
        self._next = 0
        used = [0]
        self.pages = types.SimpleNamespace(
            available=lambda: n_pages - 2 - used[0])
        self._used = used

    def attach_obs(self, obs):
        self.obs = obs

    def _worst(self, r):
        return -(-(len(r.prompt) - 1 + r.max_new) // self.page_len)

    def free_slots(self):
        return sum(r is None for r in self._slot)

    def queued_requests(self):
        return list(self._queue)

    def submit(self, prompt, max_new, seed=None):
        p = np.asarray(prompt)
        r = types.SimpleNamespace(rid=self._next, prompt=p, prompt_np=p,
                                  max_new=max_new, seed=seed)
        self._next += 1
        self._queue.append(r)
        return r.rid

    def slot_of(self, rid):
        for i, r in enumerate(self._slot):
            if r is not None and r.rid == rid:
                return i
        return None

    def _release(self, i):
        if self.paged:
            self._used[0] -= self._worst(self._slot[i])
        self._slot[i] = None

    def preempt(self, rid):
        i = self.slot_of(rid)
        req = self._slot[i]
        self._release(i)
        self.outputs.pop(rid, None)
        return req

    def step(self):
        for i in range(self.slots):
            if self._slot[i] is None and self._queue:
                if self.paged and self._worst(self._queue[0]) > \
                        self.pages.available():
                    break
                r = self._slot[i] = self._queue.pop(0)
                self._used[0] += self._worst(r) if self.paged else 0
                self.outputs[r.rid] = []
                self.request_energy_j[r.rid] = 0.125 * len(r.prompt)
        for i, r in enumerate(self._slot):
            if r is None:
                continue
            out = self.outputs[r.rid]
            out.append((r.seed * 31 + len(out) * 7) % 64)
            self.request_energy_j[r.rid] += 0.25
            if len(out) == r.max_new:
                self._release(i)


def _pumped_records(door_cls, policy, paged):
    """Submissions, pumps and grants scripted through ``door_cls`` over a
    :class:`_ScriptedScheduler`; the records, streams and preemptions."""
    sch = _ScriptedScheduler(slots=2, paged=paged, page_len=2, n_pages=9)

    async def go():
        front = door_cls(sch, enable_telemetry=False, policies={
            "hi": policy(priority=0),
            "meter": policy(priority=1, energy_budget_j=1.5,
                            refill_j_per_s=0.0)})
        front._loop = asyncio.get_running_loop()
        streams = []
        plan = {0: [("meter", 3, 6), ("lo", 4, 3)], 1: [("hi", 2, 2)],
                3: [("lo", 6, 4), ("meter", 2, 5)], 5: [("hi", 5, 3)]}
        for k in range(60):
            for tenant, n, mn in plan.get(k, ()):
                streams.append(await front.submit(
                    list(range(1, 1 + n)), mn, seed=10 + len(streams),
                    tenant=tenant))
            if k >= 9 and k % 3 == 0:
                front.adm.grant("meter", 1.0)
            front._pump_once()
            await asyncio.sleep(0)
        return front, [s.result.tokens if s.result else None
                       for s in streams]

    front, toks = asyncio.run(go())
    return ([tuple(vars(r).values()) for r in front.adm.records], toks,
            front.preemptions)


@pytest.mark.parametrize("paged", [False, True])
def test_frontdoor_decisions_equal_jax(paged):
    """Both front doors' pumps over the same scripted scheduler make the
    same admission, deferral, preemption and re-admission records and
    stream the same tokens (refill only by grants: no clock in it)."""
    ours = _pumped_records(FrontDoor, TenantPolicy, paged)
    assert ours == _pumped_records(JFrontDoor, JADM.TenantPolicy, paged)
    records, toks, preemptions = ours
    tags = {r[2] for r in records}
    assert {ADM.ADMIT, ADM.READMIT, ADM.PREEMPT_ENERGY,
            ADM.DEFER_SLOTS} <= tags and preemptions >= 1
    assert (ADM.DEFER_PAGES in tags) == paged
    assert all(t is not None for t in toks)


# -- the cases of tests/test_server.py ----------------------------------------


def test_http_stats_and_errors(dense_sched):
    """GET /stats carries j_per_token; malformed requests and unknown
    routes get the reference's 4xx codes."""
    sch = dense_sched
    sch.reset()

    async def go():
        async with HttpFrontDoor(FrontDoor(sch), port=0) as srv:
            toks, _ = await _sse_generate(srv.host, srv.port, _prompt(0), 3, 7)
            assert len(toks) == 3
            stats = await _raw(srv.host, srv.port, b"GET /stats HTTP/1.1\r\n\r\n")
            assert b"200" in _status(stats)
            payload = json.loads(stats.split(b"\r\n\r\n", 1)[1])
            assert payload["scheduler"]["decoded_tokens"] >= 3
            assert "j_per_token" in payload["scheduler"]
            assert payload["completed"] >= 1
            assert "xpike_decoded_tokens_total" in payload["metrics"]
            health = await _raw(srv.host, srv.port,
                                b"GET /healthz HTTP/1.1\r\n\r\n")
            assert json.loads(health.split(b"\r\n\r\n", 1)[1]) == {"ok": True}
            for req, code in (
                    (b"POST /generate HTTP/1.1\r\nContent-Length: 2\r\n\r\n{}",
                     b"400"),
                    (b"POST /generate HTTP/1.1\r\nContent-Length: 29\r\n\r\n"
                     b'{"prompt": [1, 64], "max_new"', b"400"),
                    (b"GET /nope HTTP/1.1\r\n\r\n", b"404"),
                    (b"GET /generate HTTP/1.1\r\n\r\n", b"405")):
                assert code in _status(await _raw(srv.host, srv.port, req))
            vocab = sch.cfg.vocab_size
            body = json.dumps({"prompt": [1, vocab], "max_new": 2}).encode()
            oov = await _raw(srv.host, srv.port, (
                f"POST /generate HTTP/1.1\r\nContent-Length: {len(body)}"
                "\r\n\r\n").encode() + body)
            assert b"400" in _status(oov)
            assert f"[0, {vocab})".encode() in oov

        off = HttpFrontDoor(FrontDoor(sch, enable_telemetry=False), port=0)
        async with off as srv:
            assert b"404" in _status(await _raw(
                srv.host, srv.port, b"GET /metrics HTTP/1.1\r\n\r\n"))

    sch.detach_obs()
    asyncio.run(go())
    sch.detach_obs()


def test_http_metrics_scrape_live(setup, paged_sched):
    """GET /metrics is well-formed Prometheus text while streams are in
    flight; after them its counters equal ServeStats; the scrape leaves
    the streams as the direct run's."""
    sch = paged_sched
    jobs = JOBS["scrape"][1]
    want = setup[2]["scrape"][0]
    sch.detach_obs()
    sch.reset()

    async def go():
        async with HttpFrontDoor(FrontDoor(sch), port=0) as srv:
            gens = [asyncio.create_task(
                _sse_generate(srv.host, srv.port, p, mn, s))
                for p, mn, s in jobs]
            live = await _raw(srv.host, srv.port, b"GET /metrics HTTP/1.1\r\n\r\n")
            got = await asyncio.gather(*gens)
            done = await _raw(srv.host, srv.port, b"GET /metrics HTTP/1.1\r\n\r\n")
            return live, done, got

    live, done, got = asyncio.run(go())
    for data in (live, done):
        head = data.partition(b"\r\n\r\n")[0]
        assert b"200" in _status(data)
        assert b"text/plain; version=0.0.4" in head
    text = done.partition(b"\r\n\r\n")[2].decode()
    assert "# TYPE xpike_decode_step_seconds histogram" in text
    assert 'xpike_admission_decisions_total{decision="admit"' in text
    samples = dict(line.rsplit(" ", 1) for line in text.splitlines()
                   if not line.startswith("#"))
    assert float(samples["xpike_decoded_tokens_total"]) == \
        sch.stats.decoded_tokens == 8
    assert float(samples["xpike_energy_joules_total"]) == pytest.approx(
        sch.stats.energy_j, rel=1e-12)
    assert text == render_prometheus(sch.obs.metrics)
    assert [t for t, _ in got] == want
    sch.detach_obs()


def test_stream_end_follows_the_pumps_gauges(setup, dense_sched,
                                             monkeypatch):
    """A stream's end reaches its client only after the pump round that
    ended it has set the front door's gauges: with the gauge updates made
    slow (each sleeps before it sets), the ``running`` and ``queue_depth``
    gauges read right after ``done`` already describe the state in which
    the stream ended, and the tokens are the direct run's."""
    sch = dense_sched
    prompt, max_new, seed = JOBS["dense"][1][0]
    want = setup[2]["dense"][0][0]
    sch.detach_obs()
    sch.reset()

    async def go():
        front = FrontDoor(sch)
        for gauge in (front._g_pending, front._g_running):
            set_now = gauge.set

            def slow_set(value, *labels, set_now=set_now):
                time.sleep(0.3)  # the pump thread, between end and gauge
                set_now(value, *labels)

            monkeypatch.setattr(gauge, "set", slow_set)
        await front.start()
        try:
            ts = await front.submit(prompt, max_new, seed=seed)
            toks = await ts.tokens()
            gauges = {g.name: g.series.get(())
                      for g in (front._g_running, front._g_pending)}
            return toks, gauges
        finally:
            await front.stop()

    toks, gauges = asyncio.run(go())
    sch.detach_obs()
    assert toks == want
    assert gauges == {"xpike_frontdoor_running": 0.0,
                      "xpike_frontdoor_queue_depth": 0.0}


def test_energy_budget_defers_until_granted(setup, dense_sched):
    """A tenant with an empty bucket is throttled (defer:energy), and its
    request proceeds, bit-exact, once credit is granted."""
    sch = dense_sched
    jobs = JOBS["defer"][1]
    want = setup[2]["defer"][0][0]
    sch.reset()

    async def go():
        front = FrontDoor(sch, enable_telemetry=False, policies={
            "broke": TenantPolicy(energy_budget_j=1e-30, refill_j_per_s=0.0,
                                  preempt=False)})
        front.adm.tenant("broke").credit_j = 0.0
        await front.start()
        try:
            ts = await front.submit(*jobs[0][:2], seed=jobs[0][2],
                                    tenant="broke")
            await asyncio.sleep(0.2)
            assert ts.result is None
            tags = [r.decision for r in front.adm.decisions(ts.request_id)]
            assert ADM.DEFER_ENERGY in tags
            front.adm.grant("broke", 1.0)
            assert await ts.tokens() == want
            assert ts.result.preemptions == 0
        finally:
            await front.stop()

    asyncio.run(go())


def test_energy_preemption_readmits_bit_exact(setup, dense_sched):
    """A budget below the request's cost forces preempt -> re-admit cycles
    (with top-ups); the client stream is still the direct one, and the
    replays are charged."""
    sch = dense_sched
    jobs = JOBS["preempt"][1]
    (want,), (full_j,) = setup[2]["preempt"]
    sch.reset()
    assert full_j > 0

    async def go():
        front = FrontDoor(sch, enable_telemetry=False, policies={
            "metered": TenantPolicy(energy_budget_j=full_j * 0.4,
                                    refill_j_per_s=0.0)})
        await front.start()
        try:
            ts = await front.submit(*jobs[0][:2], seed=jobs[0][2],
                                    tenant="metered")

            async def topup():
                # no grant before the first preemption's record exists: a
                # grant made before the pump saw the empty bucket let the
                # request run on unpreempted
                while ts.result is None and ADM.PREEMPT_ENERGY not in [
                        r.decision for r in
                        front.adm.decisions(ts.request_id)]:
                    await asyncio.sleep(0.02)
                while ts.result is None:
                    if front.adm.tenant("metered").credit_j <= 0:
                        front.adm.grant("metered", full_j * 0.4)
                    await asyncio.sleep(0.02)

            task = asyncio.create_task(topup())
            toks = await ts.tokens()
            task.cancel()
            assert toks == list(want)
            assert ts.result.preemptions >= 1
            assert ts.result.energy_j > full_j  # replays are not free
            tags = [r.decision for r in front.adm.decisions(ts.request_id)]
            assert ADM.PREEMPT_ENERGY in tags and ADM.READMIT in tags
            # a preempted request counted pending again until re-admitted
            assert front.stats_dict()["pending"] == 0
        finally:
            await front.stop()

    asyncio.run(go())


def test_pagepool_backpressure_defers_then_completes(setup, paged_sched):
    """Requests whose worst-case page reservations exceed the free pool
    wait at the front door (defer:pages) and are admitted as pages free;
    every stream equals the direct run's."""
    sch = paged_sched
    sch.detach_obs()
    sch.reset()
    jobs = JOBS["pages"][1]
    want = setup[2]["pages"][0]

    async def go():
        front = FrontDoor(sch, enable_telemetry=False)
        await front.start()
        try:
            streams = [await front.submit(p, mn, seed=s) for p, mn, s in jobs]
            assert [await ts.tokens() for ts in streams] == want
            assert ADM.DEFER_PAGES in [r.decision for r in front.adm.records]
        finally:
            await front.stop()

    asyncio.run(go())


def test_queue_full_sheds_and_validation(dense_sched):
    sch = dense_sched
    sch.reset()

    async def go():
        front = FrontDoor(sch, max_queue=1, enable_telemetry=False)
        # not started: nothing drains the queue, so the second submit sheds
        await front.submit(_prompt(0), 4, seed=1)
        with pytest.raises(QueueFull):
            await front.submit(_prompt(1), 4, seed=2)
        assert any(r.decision == ADM.DEFER_QUEUE for r in front.adm.records)
        vocab = sch.cfg.vocab_size
        for prompt, max_new, what in (
                ([], 4, "non-empty"), (_prompt(0), 0, "max_new"),
                (list(range(1, 30)), 16, "cache_len"),
                ([1, 2, vocab], 2, rf"\[0, {vocab}\)"),
                ([-1, 2], 2, rf"\[0, {vocab}\)")):
            with pytest.raises(ValueError, match=what):
                await front.submit(prompt, max_new, seed=1)

    asyncio.run(go())
    sch.reset()


def test_priority_admits_before_fairness(dense_sched):
    """With both requests queued before the first pump, the strictly
    higher priority class is admitted first whatever the arrival order."""
    sch = dense_sched
    sch.reset()

    async def go():
        front = FrontDoor(sch, enable_telemetry=False, policies={
            "batch": TenantPolicy(priority=1),
            "inter": TenantPolicy(priority=0)})
        lo = await front.submit(_prompt(3), 2, seed=31, tenant="batch")
        hi = await front.submit(_prompt(4), 2, seed=32, tenant="inter")
        await front.start()
        try:
            await asyncio.gather(lo.tokens(), hi.tokens())
            admits = [r for r in front.adm.records if r.decision == ADM.ADMIT]
            assert [r.tenant for r in admits[:2]] == ["inter", "batch"]
        finally:
            await front.stop()

    asyncio.run(go())


def test_front_door_builds_no_autograd_graph(setup):
    """The float backend's params require gradients; served through the
    front door (its pump in a thread of its own), no step output requires
    grad, and the stream equals a direct run under ``no_grad``."""
    tcfg, tparams, _ = setup

    def leaf(x):
        return (x.detach().clone().requires_grad_(True)
                if x.is_floating_point() else x)

    def tree(t):
        return {k: tree(v) for k, v in t.items()} if isinstance(t, dict) \
            else leaf(t)

    sch = BatchScheduler(tree(tparams), tcfg, get_backend("reference"),
                         device="cpu", slots=2, cache_len=16)
    with torch.no_grad():
        want = _direct(sch, [([5, 7, 9], 3, 1)])[0]
    seen = []
    decode = sch._decode

    def watched(*args):
        out = decode(*args)
        seen.append(any(isinstance(x, torch.Tensor) and x.requires_grad
                        for x in (out[0], out[2])))
        return out

    sch._decode = watched

    async def go():
        async with HttpFrontDoor(FrontDoor(sch), port=0) as srv:
            return await _sse_generate(srv.host, srv.port, [5, 7, 9], 3, 1)

    toks, _ = asyncio.run(go())
    assert toks == want[0]
    assert seen and not any(seen)


def test_front_door_under_thread_switching():
    """400 requests submitted from the loop while the pump thread runs,
    with the interpreter switching threads every microsecond: every
    request is either shed (``QueueFull``) or streams its whole scripted
    sequence, and the pending count returns to zero."""
    import sys

    sch = _ScriptedScheduler(slots=3)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        async def go():
            front = FrontDoor(sch, max_queue=48, idle_s=0.0005)
            await front.start()
            try:
                streams, shed = [], 0
                for i in range(400):
                    try:
                        streams.append((i, await front.submit(
                            [1 + i % 7, 2], 1 + i % 5, seed=i)))
                    except QueueFull:
                        shed += 1
                    await asyncio.sleep(0)
                got = await asyncio.wait_for(asyncio.gather(
                    *(ts.tokens() for _, ts in streams)), timeout=60)
                return front, streams, shed, got
            finally:
                await front.stop()

        front, streams, shed, got = asyncio.run(go())
    finally:
        sys.setswitchinterval(old)
    assert shed + len(streams) == 400 and shed > 0
    for (i, _), toks in zip(streams, got):
        assert toks == [(i * 31 + k * 7) % 64 for k in range(1 + i % 5)]
    assert front._pending_count == 0 and front.completed == len(streams)
    assert front.obs.metrics.get(
        "xpike_frontdoor_requests_total").value("completed") == len(streams)


def test_scrapes_while_tenants_and_outcomes_first_appear():
    """``GET /metrics`` and ``GET /stats`` in a loop while the pump thread
    meets 240 tenants for the first time (each a new tenant state, a new
    ``tenant_energy_credit_joules`` series) and books their outcomes, the
    interpreter switching threads every microsecond: every scrape answers
    200 with well-formed Prometheus text or JSON."""
    import sys

    sch = _ScriptedScheduler(slots=3)
    n = 240

    async def go():
        front = FrontDoor(sch, idle_s=0.0005, default_policy=TenantPolicy(
            energy_budget_j=1e6))
        async with HttpFrontDoor(front, port=0) as srv:
            scrapes = []

            async def scrape():
                for path in (b"/metrics", b"/stats"):
                    scrapes.append((path, await _raw(
                        srv.host, srv.port,
                        b"GET " + path + b" HTTP/1.1\r\n\r\n")))

            streams = []
            for i in range(n):
                streams.append(await front.submit(
                    [1 + i % 7], 1 + i % 3, seed=i, tenant=f"t{i}"))
                if i % 2:
                    await scrape()
            toks = asyncio.gather(*(s.tokens() for s in streams))
            while not toks.done():
                await scrape()
            await scrape()
            return await toks, scrapes, front

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got, scrapes, front = asyncio.run(asyncio.wait_for(go(), 60))
    finally:
        sys.setswitchinterval(old)
    assert [len(t) for t in got] == [1 + i % 3 for i in range(n)]
    for path, data in scrapes:
        assert b"200" in _status(data), (path, data[:200])
        body = data.partition(b"\r\n\r\n")[2].decode()
        if path == b"/stats":
            json.loads(body)
            continue
        for line in body.splitlines():
            if not line.startswith("#"):
                float(line.rsplit(" ", 1)[1])
    metrics, stats = (d.partition(b"\r\n\r\n")[2].decode()
                      for _, d in scrapes[-2:])
    stats = json.loads(stats)
    assert len(stats["tenants"]) == n and stats["completed"] == n
    assert metrics.count("xpike_tenant_energy_credit_joules{") == n


def test_front_door_stop_closes_the_pumps_profiler_window(setup, dense_sched,
                                                          tmp_path):
    """A profiler window the pump thread opened and the run did not fill
    is closed at ``FrontDoor.stop``, in the pump thread, and its trace
    written."""
    from repro_torch.obs import StepProfiler, Telemetry

    sch = dense_sched
    sch.detach_obs()
    sch.reset()
    prof = StepProfiler(50, str(tmp_path))
    obs = Telemetry.create(flight_dir=str(tmp_path), profiler=prof)

    async def go():
        async with HttpFrontDoor(FrontDoor(sch, telemetry=obs), port=0) as srv:
            toks, _ = await _sse_generate(srv.host, srv.port, _prompt(0), 4, 7)
            assert prof.state == "tracing"
            return toks

    try:
        toks = asyncio.run(go())
    finally:
        sch.detach_obs()
    assert len(toks) == 4
    assert prof.state == "done", prof.error
    assert prof.trace_path.endswith("steps-1-4.pt.trace.json")
    assert json.load(open(prof.trace_path))["traceEvents"]
