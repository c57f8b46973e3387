"""Training launcher with fault tolerance: a twin of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch xpikeformer-gpt-4-256 --steps 20
    python -m repro_torch.launch.train --arch xpikeformer-gpt-4-256 --device cpu
    python -m repro_torch.launch.train --arch mamba2-780m --device cpu

The LM stack (a spiking GPT on the float reference backend, or any float
arch of the registry; a MoE arch with ``moe_impl="ep_a2a"``, as the
reference launcher trains it) trains (:mod:`repro_torch.train.loop`) on
the card unless ``--device cpu``:

* **checkpoint/restart** -- an async checkpoint every ``ckpt_every``
  steps (:class:`repro_torch.checkpoint.CheckpointManager`, the reference's
  files); on start the latest one is restored and the data stream *seeks*
  to its step (``MarkovStream.batch_at(step)`` is a pure function of the
  step, and so is the step's key ``fold_in(PRNGKey(seed + 99), step)``), so
  the replay is exact;
* **elastic restart** -- ``mesh_shape`` may differ between runs: restore
  reads each rank's piece with the new mesh's placement
  (:mod:`repro_torch.launch.elastic`).  On a ``(data, model)`` mesh the
  ranks run in processes of their own (:func:`repro_torch.launch.mesh.
  run_ranks`), each holding its cut of the state (:mod:`repro_torch.
  train.loop`: heads and ``ffn`` columns over ``model``, a MoE's experts
  over ``model`` and their ``d_ff`` over ``data``); the cut state is
  gathered whole for each checkpoint, which rank 0 writes in the
  reference's files;
* **failure injection** -- ``fail_at=k`` waits for the in-flight save,
  then raises ``RuntimeError("injected failure at step k")``;
* **straggler watchdog** -- a step slower than ``straggler_factor`` times
  the median of the last 20 (once 5 are timed; each timed until its loss
  reaches the host) is logged and counted: the hook where a pod would
  re-dispatch the step, which is safe because steps are pure functions.
"""

from __future__ import annotations

import argparse
import os
import statistics
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch import prng
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ParallelConfig
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, MarkovStream
from repro_torch.launch import elastic
from repro_torch.launch.mesh import ServingMesh, run_ranks
from repro_torch.optim import adamw as A
from repro_torch.parallel.sharding import Placement
from repro_torch.train import loop as TL

_now = time.perf_counter  # the watchdog's clock


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


class StragglerWatchdog:
    """Counts steps slower than ``factor`` times the median of the last
    ``window`` step times, once more than ``after`` are timed."""

    def __init__(self, factor: float, window: int = 20, after: int = 5):
        self.factor, self.window, self.after = factor, window, after
        self.times: List[float] = []
        self.stragglers = 0

    def observe(self, dt: float) -> Optional[float]:
        """Record a step's seconds; the median it exceeded if it is a
        straggler, else ``None``."""
        self.times.append(dt)
        if len(self.times) <= self.after:
            return None
        med = statistics.median(self.times[-self.window:])
        if dt > self.factor * med:
            self.stragglers += 1
            return med
        return None


def _train(mesh: ServingMesh, arch: str, *, smoke: bool, steps: int,
           batch: int, seq_len: int, ckpt_dir: str, ckpt_every: int,
           fail_at: int, restore: bool, straggler_factor: float, seed: int,
           log_every: int, lr: float, probe: bool):
    """The train loop of one rank (the only one off a mesh) -> (its
    report, the final params)."""
    cfg = reduced_config(arch) if smoke else get_config(arch)
    dev = mesh.device
    writer = mesh.rank == 0
    parallel = ParallelConfig(remat="none")  # moe_impl "ep_a2a"
    opt = A.AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                        total_steps=steps)
    data = MarkovStream(DataConfig(cfg.vocab_size, seq_len, batch, seed=seed),
                        device=dev)
    mgr = CheckpointManager(ckpt_dir, keep=2)

    def say(msg):
        if writer:
            print(f"[train] {msg}", flush=True)

    params, opt_state = TL.init_state(seed, cfg, opt, parallel, device=dev,
                                      mesh=mesh)
    placement = TL.state_placement(cfg, mesh, parallel)
    cut = not isinstance(placement[1], Placement)
    start_step = 0
    if restore and mgr.latest_step() is not None:
        (params, opt_state), start_step = mgr.restore(
            TL.whole_like(cfg, opt, parallel), placement=placement)
        say(f"restored step {start_step} from {ckpt_dir}")

    def save(step, blocking=False):
        state = (params, opt_state)
        if cut:  # every rank gathers, a leaf at a time; rank 0 writes
            state = elastic.gather_whole(state, placement, mesh)
        if writer:
            mgr.save(step, state, blocking=blocking)
        if blocking:  # the files are on disk before any rank reads them
            mesh.barrier()

    # donated: the step writes the new state over the old one, which the
    # loop drops (a checkpoint copies it to the host first)
    step_fn = TL.make_train_step(cfg, parallel, opt, mesh=mesh, donate=True)
    out: Dict[str, Any] = {"start_step": start_step}
    if probe:
        probe_batch = data.batch_at(0)
        probe_rng = prng.PRNGKey(seed + 555, dev)
        probe_loss = TL.mesh_loss(cfg, parallel, mesh)

        def probe_fn(p):
            with torch.no_grad():
                return float(probe_loss(p, probe_batch, probe_rng)[0])

        out["probe_before"] = probe_fn(params)

    watchdog = StragglerWatchdog(straggler_factor)
    losses: List[float] = []
    for step in range(start_step, steps):
        if step == fail_at:
            mgr.wait()
            raise RuntimeError(f"injected failure at step {step}")
        t0 = _now()
        batch_data = data.batch_at(step)
        rng = prng.fold_in(prng.PRNGKey(seed + 99), step)
        params, opt_state, metrics = step_fn(params, opt_state, batch_data,
                                             rng)
        loss = float(metrics["loss"])
        dt = _now() - t0
        losses.append(loss)
        med = watchdog.observe(dt)
        if med is not None:
            say(f"straggler: step {step} took {dt:.2f}s (median {med:.2f}s)"
                " -- re-dispatch hook")
        if log_every and step % log_every == 0:
            say(f"step {step:5d} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
        if ckpt_every and (step + 1) % ckpt_every == 0:
            save(step + 1)
    save(steps, blocking=True)
    final = f"{losses[-1]:.4f}" if losses else "none (nothing left to run)"
    say(f"done: final loss {final}, stragglers {watchdog.stragglers}")
    out.update(losses=losses, step_s=watchdog.times,
               stragglers=watchdog.stragglers)
    if probe:
        out["probe_after"] = probe_fn(params)
        say(f"probe loss {out['probe_before']:.4f} -> "
            f"{out['probe_after']:.4f}")
    return out, params


def _rank_train(mesh: ServingMesh, arch: str, kw: Dict[str, Any]):
    """A rank of a mesh run (for :func:`run_ranks`): its report (plain
    data)."""
    return _train(mesh, arch, **kw)[0]


def run(arch: str, *, smoke: bool = True, steps: int = 50, batch: int = 8,
        seq_len: int = 32, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 20, fail_at: int = -1, restore: bool = True,
        mesh_shape: Sequence[int] = (1, 1), straggler_factor: float = 3.0,
        seed: int = 0, log_every: int = 10, lr: float = 1e-3,
        probe: bool = False, device=None,
        report: Optional[Dict[str, Any]] = None):
    """Train ``arch`` (``smoke``: its reduced config) for ``steps``;
    returns the per-step losses of this run (from the restored step on).

    ``probe=True`` returns ``(losses, probe_before, probe_after)``: the
    loss on step 0's batch with ``PRNGKey(seed + 555)``, before and after
    training.  ``mesh_shape = (data, model)``: any mesh, for every
    registry name (:mod:`repro_torch.train.loop`).  ``device``: the card
    unless the caller asks for the CPU (a mesh's ranks share it).
    ``report``, a dict, receives the restored step, each step's seconds
    and the straggler count (rank 0's on a mesh, with every rank's
    losses; off a mesh also the final ``params``)."""
    mesh_shape = tuple(int(x) for x in mesh_shape)
    kw = dict(smoke=smoke, steps=steps, batch=batch, seq_len=seq_len,
              ckpt_dir=ckpt_dir or default_ckpt_dir(), ckpt_every=ckpt_every,
              fail_at=fail_at, restore=restore,
              straggler_factor=straggler_factor, seed=seed,
              log_every=log_every, lr=lr, probe=probe)
    if mesh_shape[0] * mesh_shape[1] > 1:
        from repro_torch.device import resolve_device

        ranks = run_ranks(_rank_train, mesh_shape,
                          device=resolve_device(device).type,
                          args=(arch, kw))
        out = dict(ranks[0], rank_losses=[r["losses"] for r in ranks])
    else:
        out, params = _train(ServingMesh.single(device), arch, **kw)
        out["params"] = params
    if report is not None:
        report.update(out)
    if probe:
        return out["losses"], out["probe_before"], out["probe_after"]
    return out["losses"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=default_ckpt_dir())
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--no-restore", dest="restore", action="store_false")
    ap.add_argument("--mesh", type=int, nargs="+", default=[1, 1],
                    help="DATA [MODEL]: the ranks of the training mesh")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    mesh = tuple(a.mesh) if len(a.mesh) > 1 else (a.mesh[0], 1)
    run(a.arch, smoke=a.smoke, steps=a.steps, batch=a.batch,
        seq_len=a.seq_len, ckpt_dir=a.ckpt_dir, ckpt_every=a.ckpt_every,
        fail_at=a.fail_at, restore=a.restore, mesh_shape=mesh, seed=a.seed,
        device=a.device)


if __name__ == "__main__":
    main()
