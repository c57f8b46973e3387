"""Structured request-lifecycle tracing for the serving stack.

Twin of ``repro/obs/trace.py``: the same events give the same
:func:`perfetto_export` JSON and the same :class:`JsonlSink` lines.

Every interesting transition in a request's life — ``submit`` → ``admit``
→ ``prefill_chunk``\\* → ``first_token`` → ``decode``\\* →
(``preempt`` → ``readmit``)\\* → ``finish`` — is emitted as one
:class:`TraceEvent`, stamped with both the wall clock (``ts``, epoch
seconds: correlation with external logs) and the monotonic clock
(``mono``, ``time.perf_counter()``: all duration math).  The scheduler
additionally emits slot-level events (``evict``, ``gdc_recal``) so a
trace reconstructs exactly what the batch was doing at any step.

Events flow to a **pluggable sink**: any callable taking one event dict.
:class:`JsonlSink` appends one JSON object per line (the ``--trace-out``
flag on ``repro_torch/launch/serve.py``); the flight recorder
(:mod:`repro_torch.obs.recorder`) is just another sink holding per-slot rings.
The tracer itself never blocks the serving loop on I/O policy — a sink
that wants buffering brings its own.

:func:`perfetto_export` converts a list of events to the Chrome/Perfetto
``trace_event`` JSON format: per-request tracks (``tid`` = request id)
with complete spans for the queued / running phases derived from the
lifecycle pairs, and instant events for everything else — load the file
straight into ``ui.perfetto.dev``.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, IO, List, Optional, Union

Event = Dict[str, Any]
Sink = Callable[[Event], None]

# canonical lifecycle event names (the trace schema, see README)
SUBMIT = "submit"
ADMIT = "admit"
READMIT = "readmit"
PREFILL_CHUNK = "prefill_chunk"
HANDOFF = "handoff"
FIRST_TOKEN = "first_token"
DECODE = "decode"
PREEMPT = "preempt"
EVICT = "evict"
FINISH = "finish"
GDC_RECAL = "gdc_recal"
GUARD = "guard_violation"

LIFECYCLE = (SUBMIT, ADMIT, READMIT, PREFILL_CHUNK, HANDOFF, FIRST_TOKEN,
             DECODE, PREEMPT, EVICT, FINISH, GDC_RECAL, GUARD)


class Tracer:
    """Fan-out event emitter; each event is a plain dict.

    Fields: ``event`` (one of :data:`LIFECYCLE` or caller-defined), ``ts``
    (wall epoch s), ``mono`` (perf_counter s), plus whatever keyword
    fields the call site attaches (``rid``, ``slot``, ``tenant``,
    ``step``, ...).  With no sinks attached :meth:`emit` is a no-op
    after one truthiness check, so an always-constructed tracer costs
    nothing until someone listens."""

    def __init__(self, sinks: Optional[List[Sink]] = None):
        self._sinks: List[Sink] = list(sinks or [])

    def add_sink(self, sink: Sink) -> None:
        self._sinks.append(sink)

    def remove_sink(self, sink: Sink) -> None:
        self._sinks.remove(sink)

    @property
    def active(self) -> bool:
        return bool(self._sinks)

    def emit(self, event: str, **fields) -> None:
        if not self._sinks:
            return
        ev: Event = {"event": event, "ts": time.time(),
                     "mono": time.perf_counter()}
        ev.update(fields)
        for sink in self._sinks:
            sink(ev)


class JsonlSink:
    """Append events to a JSONL file (one compact JSON object per line)."""

    def __init__(self, path_or_file: Union[str, IO[str]]):
        if isinstance(path_or_file, str):
            self._f: IO[str] = open(path_or_file, "a")
            self._owned = True
        else:
            self._f = path_or_file
            self._owned = False

    def __call__(self, ev: Event) -> None:
        self._f.write(json.dumps(ev, separators=(",", ":"),
                                 default=_jsonable) + "\n")

    def close(self) -> None:
        self._f.flush()
        if self._owned:
            self._f.close()


class ListSink:
    """Keep events in a plain list (tests, Perfetto export buffers)."""

    def __init__(self):
        self.events: List[Event] = []

    def __call__(self, ev: Event) -> None:
        self.events.append(ev)


def _jsonable(x):
    try:
        return float(x)  # numpy scalars and friends
    except (TypeError, ValueError):
        return str(x)


def load_jsonl(path: str) -> List[Event]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _track(ev: Event) -> int:
    """Perfetto track id for an event: the request when known, else the
    slot (scheduler housekeeping), else track 0."""
    for key in ("fid", "rid"):
        if ev.get(key) is not None:
            return int(ev[key])
    if ev.get("slot") is not None:
        return 100000 + int(ev["slot"])
    return 0


def perfetto_export(events: List[Event]) -> Dict[str, Any]:
    """Chrome/Perfetto ``trace_event`` JSON from a list of trace events.

    Derives per-request complete spans (``ph: "X"``) for the *queued*
    (submit→admit) and *running* (admit→preempt|finish) phases and emits
    every event as an instant (``ph: "i"``) on its request's track, all
    on the monotonic timebase (µs)."""
    out: List[Dict[str, Any]] = []
    if not events:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(ev["mono"] for ev in events)

    def us(ev: Event) -> float:
        return (ev["mono"] - t0) * 1e6

    open_phase: Dict[int, Event] = {}  # track -> phase-opening event
    spans = {SUBMIT: "queued", ADMIT: "running", READMIT: "running"}
    closers = {ADMIT, READMIT, PREEMPT, FINISH}
    for ev in sorted(events, key=lambda e: e["mono"]):
        tid = _track(ev)
        name = ev["event"]
        if name in closers and tid in open_phase:
            start = open_phase.pop(tid)
            out.append({
                "name": spans[start["event"]], "ph": "X", "pid": 1,
                "tid": tid, "ts": us(start), "dur": us(ev) - us(start),
            })
        if name in spans:
            open_phase[tid] = ev
        args = {k: v for k, v in ev.items()
                if k not in ("event", "ts", "mono")
                and isinstance(v, (int, float, str, bool))}
        out.append({"name": name, "ph": "i", "s": "t", "pid": 1, "tid": tid,
                    "ts": us(ev), "args": args})
    # close dangling phases at the last event so the spans render
    t_end = max(us(ev) for ev in events)
    for tid, start in open_phase.items():
        out.append({"name": spans[start["event"]], "ph": "X", "pid": 1,
                    "tid": tid, "ts": us(start),
                    "dur": max(t_end - us(start), 0.0)})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_perfetto(events: List[Event], path: str) -> None:
    with open(path, "w") as f:
        json.dump(perfetto_export(events), f)
