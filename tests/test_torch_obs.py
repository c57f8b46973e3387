"""The port's telemetry (``repro_torch.obs``) against the JAX package's.

In one process, on the same inputs:

* the same calls on ``repro.obs.metrics`` and on the port's copy render
  the same Prometheus text, byte for byte (the golden registry and the
  label escaping of ``tests/test_obs.py``), and the same snapshots;
* the same event list gives the same ``perfetto_export`` JSON and the same
  ``JsonlSink`` lines; the flight recorders' rings and dumps are equal
  (timestamps aside);
* the ``StepProfiler`` window runs on the CPU with ``torch.profiler``,
  holds exactly its steps and writes its Chrome trace;
* the port's scheduler (the plain versions of the kernels, reduced
  ``xpikeformer-gpt-4-256``) serves the same tokens and books the same
  ``request_energy_j`` with telemetry on and off, dense and paged; its
  counters and gauges equal those of JAX's ``BatchScheduler`` with
  ``IntegerBackend`` after the same serve, on params carried across by
  ``convert.params_from_numpy`` (the step-latency histogram left out);
* a page-pool double free still raises, after the flight recorder dumped
  its postmortem.

The kernels' launch counts with telemetry on and off are the card's check
(``chip_smoke.py``, phase ``front_door``).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import obs as JO
from repro.configs import registry as JR
from repro.engine import IntegerBackend as JIntegerBackend
from repro.models import transformer as JT
from repro.obs import trace as JTR
from repro.serving import BatchScheduler as JBatchScheduler
from repro_torch import convert
from repro_torch import obs as O
from repro_torch.configs import registry as R
from repro_torch.obs import trace as TR
from repro_torch.serving import BatchScheduler

ARCH = "xpikeformer-gpt-4-256"
# dense and paged geometries of the scheduler checks
GEOMETRY = {"dense": dict(slots=2, cache_len=32),
            "paged": dict(slots=2, cache_len=32, paged=True, page_len=8,
                          n_pages=12)}
JOBS = [(list(range(3 + i, 9 + i)), 3, 70 + i) for i in range(3)]


@pytest.fixture(scope="module")
def setup():
    cfg = JR.reduced_config(ARCH)
    jparams = JT.init_params(jax.random.PRNGKey(0), cfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return cfg, R.reduced_config(ARCH), jparams, tparams


def _run(sch, jobs=JOBS):
    sch.reset()
    rids = [sch.submit(p, mn, seed=s) for p, mn, s in jobs]
    outs = sch.run()
    return [list(outs[r]) for r in rids], [sch.request_energy_j[r]
                                           for r in rids]


# -- metrics ----------------------------------------------------------------


def _golden(mod):
    """The golden registry of ``tests/test_obs.py``, a labeled histogram
    and the label escaping, built through ``mod``'s metrics."""
    reg = mod.MetricsRegistry(namespace="t")
    c = reg.counter("reqs_total", "requests", ("outcome",))
    c.inc(3, "ok")
    c.inc(1, "err")
    reg.gauge("depth", "queue depth").set(2)
    h = reg.histogram("lat_seconds", "latency", bounds=(0.125, 1.0))
    for v in (0.0625, 0.5, 5.0):
        h.observe(v)
    odd = reg.counter("odd_total", "h", ("who",))
    odd.inc(1.0, 'quo"te\\back\nline')
    lab = reg.histogram("step_seconds", "", ("mode",))
    for i, v in enumerate((3e-6, 4e-3, 0.25, 7.0, 250.0)):
        lab.observe(v, ("dense", "paged")[i % 2])
    g = reg.gauge("credit_joules", "bucket", ("tenant",))
    g.set(1.5e-7, "a")
    g.dec(2.5e-7, "a")
    return reg


def test_prometheus_text_equals_reference():
    ours, ref = _golden(O), _golden(JO)
    text = O.render_prometheus(ours)
    assert text == JO.render_prometheus(ref)
    assert r'who="quo\"te\\back\nline"' in text
    assert ours.snapshot() == ref.snapshot()
    assert O.LATENCY_BUCKETS == JO.LATENCY_BUCKETS
    assert O.log_buckets(1e-3, 7.0, 5) == JO.log_buckets(1e-3, 7.0, 5)
    with pytest.raises(ValueError):
        ours.gauge("reqs_total")  # kind mismatch, as the reference


# -- tracing and the flight recorder ----------------------------------------


def _events():
    """A lifecycle over two requests and housekeeping, stamped by hand."""
    evs = []
    for i, (name, kw) in enumerate([
            (TR.SUBMIT, dict(fid=0, tenant="a")),
            (TR.SUBMIT, dict(rid=1)),
            (TR.ADMIT, dict(rid=1, slot=0, mode="paged")),
            (TR.ADMIT, dict(fid=0, rid=2)),
            (TR.PREFILL_CHUNK, dict(rid=1, slot=0, pos=1)),
            (TR.FIRST_TOKEN, dict(rid=1, slot=0, token=np.int64(7))),
            (TR.PREEMPT, dict(fid=0, rid=2, streamed=1)),
            (TR.READMIT, dict(fid=0, rid=3)),
            (TR.GDC_RECAL, dict(t_device_s=3600.0, gain=1.25, n=1)),
            (TR.EVICT, dict(slot=1, requeue=False)),
            (TR.FINISH, dict(rid=1, slot=0, tokens=4))]):
        evs.append({"event": name, "ts": 1.7e9 + i, "mono": 10.0 + 0.25 * i,
                    **kw})
    return evs


def _strip(evs):
    return [{k: v for k, v in e.items() if k not in ("ts", "mono")}
            for e in evs]


def test_perfetto_jsonl_and_recorder_equal_reference(tmp_path):
    evs = _events()
    assert TR.LIFECYCLE == JTR.LIFECYCLE
    assert O.perfetto_export(evs) == JO.perfetto_export(evs)
    assert O.perfetto_export(evs[:4]) == JO.perfetto_export(evs[:4])
    assert O.perfetto_export([]) == JO.perfetto_export([])
    lines = {}
    for name, mod in (("port", O), ("ref", JO)):
        path = tmp_path / f"{name}.jsonl"
        sink = mod.JsonlSink(str(path))
        for e in evs:
            sink(e)
        sink.close()
        lines[name] = path.read_text()
        assert mod.load_jsonl(str(path))[5]["token"] == 7.0
    assert lines["port"] == lines["ref"]
    # a tracer's events: the same fields, each stamped on both clocks
    got = {}
    for name, mod in (("port", O), ("ref", JO)):
        sink = mod.ListSink()
        tr = mod.Tracer([sink])
        for e in _strip(evs):
            tr.emit(e["event"], **{k: v for k, v in e.items()
                                   if k != "event"})
        assert all(e["mono"] <= f["mono"]
                   for e, f in zip(sink.events, sink.events[1:]))
        got[name] = _strip(sink.events)
    assert got["port"] == got["ref"] == _strip(evs)
    # the flight recorders: rings and postmortems
    dumps = {}
    for name, mod in (("port", O), ("ref", JO)):
        rec = mod.FlightRecorder(ring_size=5, per_slot=2,
                                 out_dir=str(tmp_path / name))
        for e in evs:
            rec(e)
        assert rec.events() == evs[-5:]
        assert rec.events(slot=0) == [evs[5], evs[10]]
        reg = _golden(mod)
        path = rec.dump("double free of page 3", registry=reg,
                        extra={"pid": 3})
        assert path.endswith("flight-1-double_free_of_page_3.json")
        d = json.load(open(path))
        dumps[name] = {k: v for k, v in d.items() if k not in ("ts", "mono")}
    assert dumps["port"] == dumps["ref"]


# -- the profiler window ------------------------------------------------------


def test_step_profiler_window_on_cpu(tmp_path, monkeypatch):
    """The window opens after step ``skip - 1`` and closes after step
    ``skip + steps - 1``; its Chrome trace holds the operations of exactly
    those steps.  A session that cannot start ends in ``failed``."""
    p = O.StepProfiler(2, str(tmp_path), skip=2)
    x = torch.ones(8)
    marks = []
    for step in range(6):
        with torch.profiler.record_function(f"xpike_step_{step}"):
            x = x * 1.5
        p.tick()
        marks.append(p.state)
    assert marks == ["armed", "tracing", "tracing", "done", "done", "done"]
    trace = json.load(open(p.trace_path))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {n for n in names if str(n).startswith("xpike_step_")} == {
        "xpike_step_2", "xpike_step_3"}
    assert p.trace_path.endswith("steps-2-4.pt.trace.json")
    with pytest.raises(ValueError):
        O.StepProfiler(0, str(tmp_path))

    def refuse(*a, **kw):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    q = O.StepProfiler(1, str(tmp_path / "never"), skip=1)
    q.tick()
    assert q.state == "failed" and "no profiler here" in q.error
    q.tick()
    assert q.stop() is None and q.state == "failed"


def test_step_profiler_stops_only_in_its_own_thread(tmp_path):
    """``torch.profiler`` crashes the process when stopped in another
    thread than the one that started it: such a stop fails the window
    instead, and the session still ends in its own thread."""
    import threading

    p = O.StepProfiler(5, str(tmp_path))
    opened, release = threading.Event(), threading.Event()
    held = []

    def pump():
        p.tick()  # opens the window
        held.append(p._prof)
        opened.set()
        release.wait(30)
        held[0].stop()

    t = threading.Thread(target=pump)
    t.start()
    try:
        assert opened.wait(30) and p.state == "tracing"
        assert p.stop() is None and p.state == "failed"
        assert "another thread" in p.error
    finally:
        release.set()
        t.join()


# -- the scheduler --------------------------------------------------------------


def _counted(stats):
    """ServeStats without its wall-clock fields."""
    return {k: v for k, v in dataclasses.asdict(stats).items()
            if not k.endswith("_s") or k == "t_device_s"}


@pytest.fixture(scope="module")
def port_runs(setup, tmp_path_factory):
    """Each layout's port scheduler serving :data:`JOBS` without telemetry,
    then with a bundle and a list sink attached."""
    cfg, tcfg, jparams, tparams = setup
    runs = {}
    for layout, geometry in GEOMETRY.items():
        sch = BatchScheduler(tparams, tcfg, "integer", device="cpu",
                             **geometry)
        off = _run(sch)
        off_stats = _counted(sch.stats)
        sch.reset()  # the registry then counts the telemetry run alone
        sink = O.ListSink()
        obs = O.Telemetry.create(
            flight_dir=str(tmp_path_factory.mktemp(layout)))
        obs.tracer.add_sink(sink)
        sch.attach_obs(obs)
        runs[layout] = dict(sch=sch, off=off, off_stats=off_stats,
                            on=_run(sch), events=sink.events)
    return runs


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_telemetry_changes_no_token_or_joule(port_runs, layout):
    """Tokens, every request's joules and ServeStats are the same with
    telemetry on and off; the trace covers each request's whole arc; the
    counters mirror ServeStats."""
    run = port_runs[layout]
    sch = run["sch"]
    assert run["on"] == run["off"]
    assert _counted(sch.stats) == run["off_stats"]
    names = {e["event"] for e in run["events"]}
    assert {TR.SUBMIT, TR.ADMIT, TR.FIRST_TOKEN, TR.DECODE, TR.FINISH,
            TR.EVICT} <= names
    assert (TR.PREFILL_CHUNK in names) == (layout == "paged")
    assert ({e["rid"] for e in run["events"] if e["event"] == TR.FINISH}
            == {e["rid"] for e in run["events"] if e["event"] == TR.SUBMIT})
    m = sch.obs.metrics
    for field, metric, _ in BatchScheduler._STAT_COUNTERS:
        assert m.get(f"xpike_{metric}").value() == pytest.approx(
            float(getattr(sch.stats, field)), rel=1e-12, abs=0), metric
    assert m.get("xpike_active_slots").value() == 0
    assert m.get("xpike_decode_step_seconds").snapshot()["count"] == \
        sch.stats.decode_steps


def test_counters_equal_reference(setup, port_runs, tmp_path):
    """After the same paged serve, every counter and gauge of the port's
    registry equals that of JAX's ``BatchScheduler`` with
    ``IntegerBackend`` (the step-latency histogram left out), and so does
    the token stream."""
    cfg, tcfg, jparams, tparams = setup
    jsch = JBatchScheduler(jparams, cfg, JIntegerBackend(),
                           **GEOMETRY["paged"])
    jsch.attach_obs(JO.Telemetry.create(flight_dir=str(tmp_path)))
    assert _run(jsch)[0] == port_runs["paged"]["on"][0]
    snaps = [s.obs.metrics.snapshot() for s in (jsch,
                                                port_runs["paged"]["sch"])]
    for snap in snaps:
        snap.pop("xpike_decode_step_seconds")
    assert snaps[1] == snaps[0]
    assert [(f, m) for f, m, _ in BatchScheduler._STAT_COUNTERS] == [
        (f, m) for f, m, _ in JBatchScheduler._STAT_COUNTERS]
    assert JO.render_prometheus(jsch.obs.metrics).count("\n") == \
        O.render_prometheus(port_runs["paged"]["sch"].obs.metrics).count("\n")


def test_pool_guard_dumps_the_flight_recorder(setup, tmp_path):
    """A double free still raises, and the armed recorder wrote its
    postmortem first (events, metrics, reason); so do a use after free and
    an evict of an empty slot, each to a file of its own."""
    cfg, tcfg, jparams, tparams = setup
    obs = O.Telemetry.create(flight_dir=str(tmp_path))
    sch = BatchScheduler(tparams, tcfg, "integer", device="cpu", obs=obs,
                         **GEOMETRY["paged"])
    sch.submit(list(range(3, 9)), 2, seed=1)
    pid = sch.pages.alloc()
    sch.pages.release(pid)
    with pytest.raises(ValueError, match="double free"):
        sch.pages.release(pid)
    assert len(obs.recorder.dumps) == 1
    dump = json.load(open(obs.recorder.dumps[0]))
    assert "double free" in dump["reason"]
    assert any(e["event"] == TR.SUBMIT for e in dump["events"])
    assert "xpike_decode_steps_total" in dump["metrics"]
    with pytest.raises(ValueError, match="use-after-free"):
        sch.pages.retain(pid)
    with pytest.raises(ValueError, match="unoccupied"):
        sch.evict(1)
    assert len(set(obs.recorder.dumps)) == 3
    sch.detach_obs()
    with pytest.raises(ValueError, match="double free"):
        sch.pages.release(pid)
    assert len(obs.recorder.dumps) == 3  # disarmed
