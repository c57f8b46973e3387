"""Low-overhead serving metrics: counters, gauges, log-bucket histograms.

Twin of ``repro/obs/metrics.py``: the same calls render the same
Prometheus text, byte for byte.  The registry is **host-side only** --
plain Python floats and ints mutated from the scheduler / front-door
bookkeeping loops, never read from or written to the device -- so
attaching it cannot change a decoded token or a booked joule, and adds no
kernel launch and no host-device synchronisation to a step.  Overhead per
observation is one dict lookup plus a float add (histograms: one
``bisect`` over ~30 bucket bounds).

Design notes:

* **fixed log-spaced buckets** — histograms quantise into geometric bucket
  bounds chosen at *registration* time (default 1 µs .. ~100 s for
  latencies).  Serving latencies span five orders of magnitude between a
  warm decode step and a cold compile, so log buckets hold relative error
  constant where linear buckets would waste every bin on the tail.
* **label sets, not label dicts, on the hot path** — a metric family keyed
  by a tuple of label *values* (the label *names* are fixed per family),
  so the per-observation cost is hashing a small tuple.
* **exposition** — :func:`render_prometheus` emits Prometheus text format
  0.0.4 (``# HELP`` / ``# TYPE`` + samples, histograms as cumulative
  ``_bucket{le=...}`` series with ``+Inf``/``_sum``/``_count``), served by
  ``GET /metrics``; :meth:`MetricsRegistry.snapshot` returns the same
  state as a nested dict for the richer ``GET /stats``.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LabelValues = Tuple[str, ...]

_INF = float("inf")


def log_buckets(lo: float, hi: float, per_decade: int = 3) -> Tuple[float, ...]:
    """Fixed log-spaced histogram bounds covering ``[lo, hi]``.

    ``per_decade`` bounds per power of ten, snapped to a geometric grid
    anchored at ``lo`` — deterministic for a given (lo, hi, per_decade),
    so exposition output is stable across runs and processes."""
    if not (lo > 0 and hi > lo):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
    ratio = 10.0 ** (1.0 / per_decade)
    return tuple(lo * ratio ** i for i in range(n))


# default latency bounds: 1 us .. ~100 s, 3 per decade (~25 buckets) —
# wide enough for a first step that builds the kernels, fine enough for
# a warm decode step
LATENCY_BUCKETS = log_buckets(1e-6, 100.0)


class Counter:
    """Monotone counter family; label-free fast path is a float add."""

    kind = "counter"

    def __init__(self, name: str, help: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self.series: Dict[LabelValues, float] = {}
        if not self.label_names:
            self.series[()] = 0.0

    def inc(self, amount: float = 1.0, *labels: str) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        if len(labels) != len(self.label_names):
            raise ValueError(
                f"{self.name} takes labels {self.label_names}, got {labels}")
        self.series[labels] = self.series.get(labels, 0.0) + amount

    def value(self, *labels: str) -> float:
        return self.series.get(labels, 0.0)

    def samples(self) -> Iterable[Tuple[str, LabelValues, float]]:
        for labels, v in list(self.series.items()):
            yield self.name, labels, v

    def snapshot(self):
        if not self.label_names:
            return self.series.get((), 0.0)
        return {",".join(k): v for k, v in list(self.series.items())}


class Gauge(Counter):
    """Set-to-current-value metric (occupancy, depths, clocks, gains)."""

    kind = "gauge"

    def set(self, value: float, *labels: str) -> None:
        if len(labels) != len(self.label_names):
            raise ValueError(
                f"{self.name} takes labels {self.label_names}, got {labels}")
        self.series[labels] = float(value)

    def inc(self, amount: float = 1.0, *labels: str) -> None:
        self.series[labels] = self.series.get(labels, 0.0) + amount

    def dec(self, amount: float = 1.0, *labels: str) -> None:
        self.inc(-amount, *labels)


class _HistogramSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative) counts
        self.sum = 0.0
        self.count = 0


class Histogram:
    """Fixed-bucket histogram family (defaults to log-spaced latency bounds).

    ``bounds`` are upper-inclusive bucket edges; observations above the
    last bound land in the implicit ``+Inf`` bucket.  Exposition follows
    the Prometheus cumulative convention."""

    kind = "histogram"

    def __init__(self, name: str, help: str, label_names: Sequence[str] = (),
                 bounds: Sequence[float] = LATENCY_BUCKETS):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"histogram {name} bounds must strictly increase")
        self.series: Dict[LabelValues, _HistogramSeries] = {}
        if not self.label_names:
            self.series[()] = _HistogramSeries(len(self.bounds) + 1)

    def observe(self, value: float, *labels: str) -> None:
        if len(labels) != len(self.label_names):
            raise ValueError(
                f"{self.name} takes labels {self.label_names}, got {labels}")
        s = self.series.get(labels)
        if s is None:
            s = self.series[labels] = _HistogramSeries(len(self.bounds) + 1)
        s.counts[bisect_left(self.bounds, value)] += 1
        s.sum += value
        s.count += 1

    def bucket_counts(self, *labels: str) -> List[int]:
        """Non-cumulative per-bucket counts (last entry = +Inf bucket)."""
        s = self.series.get(labels)
        return list(s.counts) if s else [0] * (len(self.bounds) + 1)

    def snapshot(self):
        def one(s: _HistogramSeries):
            return {"buckets": list(s.counts), "sum": s.sum, "count": s.count,
                    "bounds": list(self.bounds)}
        if not self.label_names:
            return one(self.series[()])
        return {",".join(k): one(s) for k, s in list(self.series.items())}


class MetricsRegistry:
    """Name -> metric map with get-or-create registration.

    Registration is threadsafe (the front door's pump thread and the
    asyncio loop both create families lazily); per-sample mutation is a
    GIL-atomic dict/float op and deliberately unlocked — a torn read in an
    exposition scrape costs one sample of staleness, never corruption.
    Readers copy a family's series (``list(series.items())``, one C call)
    before they loop, so a label set that first appears in the pump thread
    mid-scrape cannot change the dict under the loop."""

    def __init__(self, namespace: str = "xpike"):
        self.namespace = namespace
        self._metrics: Dict[str, Counter] = {}  # Counter | Gauge | Histogram
        self._lock = threading.Lock()

    def _register(self, cls, name: str, help: str, label_names, **kw):
        full = f"{self.namespace}_{name}" if self.namespace else name
        with self._lock:
            m = self._metrics.get(full)
            if m is None:
                m = self._metrics[full] = cls(full, help, label_names, **kw)
        # compare kinds, not isinstance: Gauge subclasses Counter, so a
        # gauge re-registered as a counter must still be rejected
        if m.kind != cls.kind or m.label_names != tuple(label_names):
            raise ValueError(
                f"metric {full} re-registered as {cls.__name__}"
                f"{tuple(label_names)} (was {type(m).__name__}"
                f"{m.label_names})")
        return m

    def counter(self, name: str, help: str = "",
                label_names: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, label_names)

    def gauge(self, name: str, help: str = "",
              label_names: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, label_names)

    def histogram(self, name: str, help: str = "",
                  label_names: Sequence[str] = (),
                  bounds: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, label_names,
                              bounds=bounds)

    def get(self, full_name: str) -> Optional[Counter]:
        return self._metrics.get(full_name)

    def metrics(self) -> List[Counter]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> Dict[str, dict]:
        """Nested plain-dict view of every family (the ``/stats`` payload)."""
        return {m.name: {"kind": m.kind, "help": m.help,
                         "labels": list(m.label_names),
                         "values": m.snapshot()}
                for m in self.metrics()}


def _fmt(v: float) -> str:
    if v == _INF:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(names: Sequence[str], values: LabelValues,
               extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = list(zip(names, values)) + list(extra)
    if not pairs:
        return ""
    def esc(s: str) -> str:
        return s.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in pairs) + "}"


def render_prometheus(registry: MetricsRegistry) -> str:
    """Prometheus text exposition format 0.0.4 for ``GET /metrics``."""
    lines: List[str] = []
    for m in registry.metrics():
        lines.append(f"# HELP {m.name} {m.help or m.name}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            for labels, s in list(m.series.items()):
                cum = 0
                for bound, c in zip(m.bounds + (_INF,), s.counts):
                    cum += c
                    ls = _label_str(m.label_names, labels,
                                    (("le", _fmt(bound)),))
                    lines.append(f"{m.name}_bucket{ls} {cum}")
                ls = _label_str(m.label_names, labels)
                lines.append(f"{m.name}_sum{ls} {_fmt(s.sum)}")
                lines.append(f"{m.name}_count{ls} {s.count}")
        else:
            for name, labels, v in m.samples():
                lines.append(
                    f"{name}{_label_str(m.label_names, labels)} {_fmt(v)}")
    return "\n".join(lines) + "\n"
