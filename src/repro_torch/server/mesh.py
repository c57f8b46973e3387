"""The front door over a ``(data, model)`` mesh of one process a rank.

The reference serves a mesh from one process: its ``FrontDoor`` drives the
``Executor``'s scheduler, which ``shard_map`` spreads over the devices.
The port runs a process a rank (:mod:`repro_torch.launch.mesh`), and every
rank's :class:`~repro_torch.serving.BatchScheduler` must take the same
``submit``/``preempt``/``step`` sequence: a step is a sequence of
collectives (the model group's sums and all-to-alls, the data group's
gathers, the drift clock's broadcast), and a rank that skips one hangs
the others.  Given the same sequence, tokens, pages, energy and the drift
clock are the same on every rank (:mod:`repro_torch.distributed.
executor`).  So:

* rank 0 runs the :class:`~repro_torch.server.FrontDoor` (and the HTTP
  server, the admission controller and the telemetry) over a
  :class:`MeshLeader` wrapped around its scheduler.  The leader logs each
  ``submit`` and ``preempt`` and, before each ``step``, broadcasts the log
  with the order to step (:meth:`ServingMesh.broadcast_bytes
  <repro_torch.launch.mesh.ServingMesh.broadcast_bytes>`).  Every decision
  (admission, joule buckets, preemption, the replay check) is rank 0's:
  only its effects travel;
* every other rank runs :func:`follow`: it takes each broadcast, applies
  its log in order and steps when told to, until :data:`STOP`.

An idle leader broadcasts a no-op every ``heartbeat_s``
(:meth:`MeshLeader.heartbeat`), so that no follower waits inside one
collective for longer than the process group's timeout.  A follower
that dies makes rank 0's next collective raise; the front door's pump
then fails every open stream, and the run fails.
"""

from __future__ import annotations

import pickle
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

SUBMIT, PREEMPT = "submit", "preempt"  # logged calls
STEP, NOOP, STOP = "step", "noop", "stop"  # what follows a log
HEARTBEAT_S = 5.0  # well inside DEFAULT_TIMEOUT_S (launch/mesh.py)


class MeshLeader:
    """Rank 0's scheduler as the front door drives it (see the module):
    ``submit`` and ``preempt`` are applied and logged, ``step``
    broadcasts the log first, and everything else (``free_slots``,
    ``queued_requests``, ``slot_of``, ``outputs``, ``request_energy_j``,
    ``pages``, ``stats``, ``obs``, ``attach_obs``, ...) reads through to
    the scheduler."""

    def __init__(self, scheduler, mesh, heartbeat_s: float = HEARTBEAT_S):
        self.scheduler = scheduler
        self.mesh = mesh
        self.heartbeat_s = heartbeat_s
        self.closed = False
        self.broken = False  # a broadcast or a step raised
        self._log: List[tuple] = []
        self._sent = time.monotonic()

    def __getattr__(self, name: str) -> Any:
        return getattr(self.scheduler, name)

    def submit(self, prompt: Sequence[int], max_new: int,
               seed: Optional[int] = None) -> int:
        rid = self.scheduler.submit(prompt, max_new, seed=seed)
        self._log.append((SUBMIT, np.asarray(prompt, np.int64).tolist(),
                          max_new, seed, rid))
        return rid

    def preempt(self, rid: int):
        req = self.scheduler.preempt(rid)
        self._log.append((PREEMPT, rid))
        return req

    def step(self) -> int:
        self._send(STEP)
        try:
            return self.scheduler.step()
        except BaseException:
            self.broken = True
            raise

    def heartbeat(self) -> None:
        """A no-op broadcast (with the log) once ``heartbeat_s`` has passed
        since the last broadcast: the idle front door's pump calls it."""
        if time.monotonic() - self._sent >= self.heartbeat_s:
            self._send(NOOP)

    def close(self) -> None:
        """Broadcast :data:`STOP` (once): the followers return.  After a
        failed broadcast or step the mesh is not whole, and nothing is
        sent: the run fails instead."""
        if not (self.closed or self.broken):
            self._send(STOP)
        self.closed = True

    def _send(self, op: str) -> None:
        if self.closed:
            raise RuntimeError("the mesh leader is closed")
        log, self._log = self._log, []
        try:
            self.mesh.broadcast_bytes(pickle.dumps((log, op)))
        except BaseException:
            self.broken = True
            raise
        self._sent = time.monotonic()


def follow(scheduler, mesh) -> Dict[str, Any]:
    """A follower rank's loop (see the module): apply rank 0's commands
    to ``scheduler`` until :data:`STOP`.  A ``submit`` whose rid differs
    from rank 0's raises (the ranks would serve different requests).
    Returns the steps and no-ops taken, and the longest wait for a
    broadcast after the first."""
    steps = noops = 0
    longest = 0.0
    first = True
    while True:
        t0 = time.monotonic()
        # rank 0's own bytes (pickled by MeshLeader._send)
        log, op = pickle.loads(mesh.broadcast_bytes(None))
        if not first:
            longest = max(longest, time.monotonic() - t0)
        first = False
        for cmd in log:
            if cmd[0] == SUBMIT:
                _, prompt, max_new, seed, rid = cmd
                got = scheduler.submit(prompt, max_new, seed=seed)
                if got != rid:
                    raise RuntimeError(
                        f"rank {mesh.rank}: submit gave rid {got}, rank 0 "
                        f"got {rid}; the ranks' schedulers diverged")
            else:
                scheduler.preempt(cmd[1])
        if op == STOP:
            return {"steps": steps, "noops": noops, "longest_wait_s": longest}
        if op == STEP:
            scheduler.step()
            steps += 1
        else:
            noops += 1
