"""Flight recorder: bounded rings of recent trace events + postmortem dump.

Twin of ``repro/obs/recorder.py``.

A long-running server cannot keep (or ship) a full trace, but the moment a
scheduler or page-pool **invariant guard** fires — double free,
use-after-free, evict of an unoccupied slot — the last few hundred events
are exactly what the postmortem needs.  The :class:`FlightRecorder` is a
trace sink (:mod:`repro_torch.obs.trace`) holding fixed-size rings:

* one **global ring** (admissions, decode steps, GDC recalibrations, ...);
* one ring **per slot**, so the history of the slot that tripped the guard
  is not drowned out by the other slots' traffic.

:meth:`FlightRecorder.dump` writes a single JSON postmortem — the rings,
the violation reason, a wall/monotonic timestamp pair and (when a registry
is attached) the full metrics snapshot — and returns the path.  The
scheduler arms its guard sites (``BatchScheduler.evict``,
``PagePool.release``/``retain`` via :attr:`~repro_torch.serving.pages.PagePool.
on_violation`) to dump *before* re-raising, so the exception the test or
operator sees is unchanged but the evidence is already on disk.

Dumping is deliberately idempotent-ish: each dump gets a fresh numbered
file (``flight-<n>-<reason>.json``) so a cascade of guard hits during
teardown cannot overwrite the first — usually the interesting — one.
"""

from __future__ import annotations

import json
import os
import re
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from repro_torch.obs.trace import Event


class FlightRecorder:
    """Fixed-size per-slot + global rings of recent trace events."""

    def __init__(self, ring_size: int = 256, per_slot: int = 64,
                 out_dir: str = "."):
        self.ring_size = ring_size
        self.per_slot = per_slot
        self.out_dir = out_dir
        self._global: Deque[Event] = deque(maxlen=ring_size)
        self._slots: Dict[int, Deque[Event]] = {}
        self.dumps: List[str] = []  # paths written so far
        self._n = 0

    # -- sink protocol (Tracer fan-out) ---------------------------------

    def __call__(self, ev: Event) -> None:
        self.record(ev)

    def record(self, ev: Event) -> None:
        self._global.append(ev)
        slot = ev.get("slot")
        if slot is not None:
            ring = self._slots.get(slot)
            if ring is None:
                ring = self._slots[slot] = deque(maxlen=self.per_slot)
            ring.append(ev)

    # -- postmortem ------------------------------------------------------

    def dump(self, reason: str, *, registry=None,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Write a postmortem JSON for ``reason``; returns its path."""
        slug = re.sub(r"[^A-Za-z0-9_.-]+", "_", reason)[:48] or "guard"
        self._n += 1
        path = os.path.join(self.out_dir, f"flight-{self._n}-{slug}.json")
        payload: Dict[str, Any] = {
            "reason": reason,
            "ts": time.time(),
            "mono": time.perf_counter(),
            "events": list(self._global),
            "slots": {str(k): list(v) for k, v in list(self._slots.items())},
        }
        if registry is not None:
            payload["metrics"] = registry.snapshot()
        if extra:
            payload["extra"] = extra
        os.makedirs(self.out_dir or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, default=str)
        self.dumps.append(path)
        return path

    def events(self, slot: Optional[int] = None) -> List[Event]:
        if slot is None:
            return list(self._global)
        return list(self._slots.get(slot, ()))
