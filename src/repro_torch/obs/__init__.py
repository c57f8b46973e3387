"""Serving observability: metrics registry, lifecycle tracing, flight
recorder and a ``torch.profiler`` window.

Twin of ``repro/obs``.  One :class:`Telemetry` bundle threads through the
whole serving stack -- :class:`~repro_torch.serving.BatchScheduler`, the
:class:`~repro_torch.server.FrontDoor` admission layer and the HTTP
transport -- so a single object answers "what is this server doing right
now":

* :attr:`Telemetry.metrics` -- a :class:`MetricsRegistry` of host-side
  counters / gauges / log-bucket histograms, exposed as Prometheus text
  at ``GET /metrics`` and nested into ``GET /stats``;
* :attr:`Telemetry.tracer` -- request-lifecycle events
  (submit -> admit -> prefill -> first token -> decode -> preempt/readmit
  -> finish) to pluggable sinks (JSONL via ``--trace-out``, Perfetto
  export);
* :attr:`Telemetry.recorder` -- a flight recorder of recent per-slot
  events, dumped to a postmortem file when a scheduler/page-pool
  invariant guard raises;
* :attr:`Telemetry.profiler` -- opt-in ``torch.profiler`` capture of N
  decode steps (``--profile-steps`` / ``--profile-dir``).

Everything here is host-side bookkeeping over the scheduler's Python
loop: every gauge reads Python state, so attaching telemetry changes no
decoded token and no booked joule, and adds no kernel launch and no
host-device synchronisation to a step.  The one device read is the mean
GDC gain of programmed params, at attach and after a recalibration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.metrics import (LATENCY_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry, log_buckets,
                                     render_prometheus)
from repro_torch.obs.profiler import StepProfiler
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import (JsonlSink, ListSink, Tracer, load_jsonl,
                                   perfetto_export, write_perfetto)


@dataclasses.dataclass
class Telemetry:
    """The telemetry bundle threaded through scheduler / front door / HTTP."""

    metrics: MetricsRegistry
    tracer: Tracer
    recorder: Optional[FlightRecorder] = None
    profiler: Optional[StepProfiler] = None

    @classmethod
    def create(cls, *, flight_dir: str = ".",
               flight_ring: int = 256,
               profiler: Optional[StepProfiler] = None) -> "Telemetry":
        """Standard bundle: registry + tracer + armed flight recorder (the
        recorder listens to the tracer, so guard-site dumps always have
        recent history even when no external trace sink is attached)."""
        recorder = FlightRecorder(ring_size=flight_ring, out_dir=flight_dir)
        tracer = Tracer([recorder])
        return cls(metrics=MetricsRegistry(), tracer=tracer,
                   recorder=recorder, profiler=profiler)

    def trace(self, event: str, **fields) -> None:
        self.tracer.emit(event, **fields)

    def guard_dump(self, reason: str, **extra) -> Optional[str]:
        """Flight-recorder postmortem for an invariant violation (no-op
        without a recorder); returns the dump path."""
        if self.recorder is None:
            return None
        self.trace("guard_violation", reason=reason, **extra)
        return self.recorder.dump(reason, registry=self.metrics,
                                  extra=extra or None)


__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "JsonlSink",
    "LATENCY_BUCKETS",
    "ListSink",
    "MetricsRegistry",
    "StepProfiler",
    "Telemetry",
    "Tracer",
    "load_jsonl",
    "log_buckets",
    "perfetto_export",
    "render_prometheus",
    "write_perfetto",
]
