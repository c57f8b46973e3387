"""Opt-in ``torch.profiler`` capture of a window of decode steps.

Twin of ``repro/obs/profiler.py`` on ``torch.profiler``:
``launch/serve.py --profile-steps N --profile-dir DIR`` arms a
:class:`StepProfiler` on the scheduler, which opens a profiler session
right before decode step ``skip`` (default 1: step 0 builds the kernels
and warms the allocator) and closes it ``N`` steps later, writing a
Chrome trace (``chrome://tracing`` or ui.perfetto.dev) into ``DIR``.  The
session records ``ProfilerActivity.CPU``, and ``ProfilerActivity.CUDA``
when the scheduler it is attached to serves on a GPU, so the trace holds
each step's kernels.

:meth:`StepProfiler.tick` runs after a step's tokens reached the host
(the scheduler reads them back at the end of every step), so the window
opens and closes on finished device work and holds exactly ``steps``
steps: ``[skip, skip + steps)``.  (The reference opens its window at the
tick *of* step ``skip``, after that step ran, so it holds one step fewer
than it names.)

The profiler is host-side control flow around the step: arming it changes
no token.  A session that cannot start ends the window in state
``failed`` (reported once on stderr) rather than killing the serve loop;
callers that need the trace check :attr:`state`.  ``torch.profiler``
must be stopped in the thread that started it (another thread's stop
crashes the process), so :meth:`stop` from any other thread fails the
window instead; the front door closes a window its pump opened in the
pump thread.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Optional


class StepProfiler:
    """Capture decode steps ``[skip, skip + steps)`` into ``out_dir``."""

    def __init__(self, steps: int, out_dir: str, *, skip: int = 1):
        if steps < 1:
            raise ValueError(f"profile window must be >= 1 step, got {steps}")
        if skip < 1:
            raise ValueError("the window opens after a completed step: "
                             f"skip must be >= 1, got {skip}")
        self.steps = steps
        self.out_dir = out_dir
        self.skip = skip
        # record the card too: set by the scheduler it is attached to
        self.cuda = False
        self.trace_path: Optional[str] = None
        self.error: Optional[str] = None
        self._seen = 0  # steps completed so far
        self._t0_step = 0
        self._prof = None
        self._thread: Optional[int] = None  # the thread that started it
        self.state = "armed"  # armed -> tracing -> done | failed

    @property
    def tracing(self) -> bool:
        return self.state == "tracing"

    @property
    def done(self) -> bool:
        return self.state in ("done", "failed")

    def tick(self) -> None:
        """Call once per completed decode step (its tokens on the host)."""
        if self.done:
            return
        self._seen += 1
        if self.state == "tracing":
            if self._seen - self._t0_step >= self.steps:
                self.stop()
        elif self._seen == self.skip:
            self._start()

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        try:
            self._prof = profile(activities=acts)
            self._prof.start()
        except Exception as e:  # a profiler that cannot start
            self._fail(f"torch.profiler capture unavailable: {e}")
            return
        self.state = "tracing"
        self._t0_step = self._seen
        self._thread = threading.get_ident()

    def _fail(self, msg: str) -> None:
        self.state = "failed"
        self.error = msg
        self._prof = None
        print(f"[obs] {msg}", file=sys.stderr)

    def stop(self) -> Optional[str]:
        """Close an open capture (also called when the scheduler drains)
        and write its Chrome trace; returns the trace's path."""
        if self.state != "tracing":
            return None
        if threading.get_ident() != self._thread:
            self._fail("torch.profiler stop from another thread than the "
                       "one that started the capture")
            return None
        captured = self._seen - self._t0_step
        path = os.path.join(
            self.out_dir,
            f"steps-{self._t0_step}-{self._seen}.pt.trace.json")
        try:
            self._prof.stop()
            os.makedirs(self.out_dir or ".", exist_ok=True)
            self._prof.export_chrome_trace(path)
        except Exception as e:
            self._fail(f"torch.profiler stop failed: {e}")
            return None
        self._prof = None
        self.state = "done"
        self.trace_path = path
        print(f"[obs] captured {captured} decode steps to {path} "
              "(chrome://tracing or ui.perfetto.dev)", file=sys.stderr)
        return path
