"""The ``(data, model)`` serving mesh of the port: one process per rank.

Twin of ``repro/launch/mesh.py`` (``parse_mesh_spec``,
``make_serving_mesh``).  JAX runs a mesh in one process under
``shard_map``; the port runs one process per mesh position and names the
communication explicitly:

* :class:`ServingMesh` -- the shape ``(data, model)``, this rank's
  coordinates (``rank = data_index * model + model_index``), its device,
  and two process groups: the ``model`` group (the ranks of its data row,
  which split heads and crossbar rows/columns) and the ``data`` group (the
  ranks of its model column, which split decode slots);
* :func:`init_mesh` -- ``torch.distributed`` with every group created on
  every rank in the same order (a rank that creates only its own groups
  deadlocks the others), each with a timeout;
* :func:`run_ranks` -- spawn the ranks, run ``fn(mesh, *args)`` on each,
  collect every rank's result in the caller, and fail (killing the rest)
  as soon as one rank fails or the timeout passes.

The process-group backend follows where the ranks run: ``nccl`` when
every rank has a card of its own, ``gloo`` otherwise -- on the CPU, and
for several ranks sharing one card (NCCL refuses two ranks on one
device; gloo stages each collective through the host).  Gloo runs
``all_reduce`` and ``broadcast`` on CUDA tensors (staging them itself) and
``all_to_all`` on CPU tensors only, so a caller under gloo moves the
operand of an all-to-all to :attr:`ServingMesh.host_device` first, and
every gather here is an ``all_reduce`` of a zero-filled buffer, which is
exact for the data it carries (each element is filled by one rank).
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

Shape = Tuple[int, int]
DEFAULT_TIMEOUT_S = 300.0


def parse_mesh_spec(spec: str) -> Shape:
    """A ``--mesh`` value -> ``(data, model)``: ``"2x4"`` or ``"2,4"``, a
    single integer (data-parallel only), or ``"auto"`` (every visible card
    on the data axis; one rank without a card)."""
    s = spec.strip().lower()
    if s in ("auto", ""):
        return (max(torch.cuda.device_count(), 1), 1)
    dims = tuple(int(p) for p in s.replace("x", ",").split(",") if p)
    if len(dims) == 1:
        return (dims[0], 1)
    if len(dims) != 2:
        raise ValueError(f"--mesh wants 'DATAxMODEL' (e.g. 2x4), got {spec!r}")
    return dims  # type: ignore[return-value]


def pick_backend(world: int, device: str) -> str:
    """``nccl`` when each of ``world`` ranks has a card of its own,
    ``gloo`` on the CPU or when ranks share a card."""
    if device == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


@dataclasses.dataclass
class ServingMesh:
    """One rank's view of a ``(data, model)`` mesh (see the module)."""

    shape: Shape
    rank: int
    device: torch.device
    backend: str = "gloo"
    model_group: Any = None
    data_group: Any = None

    @classmethod
    def single(cls, device="cuda") -> "ServingMesh":
        """The ``(1, 1)`` mesh of one process: no process group, every
        collective a no-op.  CUDA unless the caller asks for the CPU."""
        from repro_torch.device import resolve_device

        return cls((1, 1), 0, resolve_device(device))

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def model(self) -> int:
        return self.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def host_device(self) -> torch.device:
        """Where a collective on host-bound data runs: the CPU under gloo
        (which stages a CUDA tensor through the host anyway), the card
        under NCCL."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def all_reduce_model(self, x: torch.Tensor) -> torch.Tensor:
        """In place: the sum of ``x`` over the model group."""
        if self.model > 1:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.model_group)
        return x

    def all_to_all_model(self, x: torch.Tensor) -> torch.Tensor:
        """The tiled all-to-all over the model group on the leading axis
        (``lax.all_to_all(x, "model", 0, 0, tiled=True)``): ``x``'s
        ``model`` equal blocks go to the group's ranks in order, and the
        result holds the blocks the ranks sent this one, in rank order.
        On the card under NCCL; through the host under gloo (which runs an
        all-to-all on CPU tensors only).  The identity at ``model = 1``."""
        if self.model <= 1:
            return x
        src = x.to(self.host_device).contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.model_group)
        return out.to(x.device)

    def all_reduce_data(self, x: torch.Tensor) -> torch.Tensor:
        """In place: the sum of ``x`` over the data group."""
        if self.data > 1:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.data_group)
        return x

    def broadcast_float(self, x: float) -> float:
        """Global rank 0's value of ``x`` on every rank."""
        if self.data * self.model == 1:
            return x
        t = torch.tensor([x], dtype=torch.float64, device=self.host_device)
        dist.broadcast(t, src=0)
        return float(t[0])


def _groups(shape: Shape, timeout: datetime.timedelta):
    """Every model group (one per data row), then every data group (one
    per model column), created in this order on every rank."""
    d, m = shape
    model_groups = [dist.new_group([i * m + j for j in range(m)],
                                   timeout=timeout) for i in range(d)]
    data_groups = [dist.new_group([i * m + j for i in range(d)],
                                  timeout=timeout) for j in range(m)]
    return model_groups, data_groups


def init_mesh(shape: Shape, rank: int, *, init_method: str,
              device: str = "cuda",
              timeout_s: float = DEFAULT_TIMEOUT_S) -> ServingMesh:
    """Join the ``shape`` mesh as ``rank``: ``init_process_group`` (the
    caller's ``init_method``: a ``file://`` path, ``env://`` under
    ``torchrun``, or ``tcp://host:port``), then every group.  ``device``
    ``"cuda"`` puts rank ``r`` on card ``r`` under NCCL and every rank on
    card 0 under gloo; a CUDA request without a card raises."""
    from repro_torch.device import resolve_device

    world = shape[0] * shape[1]
    backend = pick_backend(world, device)
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout)
    model_groups, data_groups = _groups(shape, timeout)
    d_i, m_i = divmod(rank, shape[1])
    return ServingMesh(tuple(shape), rank, dev, backend,
                       model_groups[d_i], data_groups[m_i])


def _rank_main(rank: int, shape: Shape, init_method: str, device: str,
               timeout_s: float, job_path: str, results) -> None:
    try:
        torch.set_num_threads(1)
        with open(job_path, "rb") as f:
            fn, args = pickle.load(f)
        mesh = init_mesh(shape, rank, init_method=init_method, device=device,
                         timeout_s=timeout_s)
        with torch.no_grad():
            out = fn(mesh, *args)
        results.put((rank, True, out))
    except BaseException:  # reported to the caller, which fails the run
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, shape: Shape, *, device: str = "cuda",
              args: Sequence[Any] = (),
              timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(mesh, *args)`` on each rank of a ``shape`` mesh, one
    spawned process per rank (CUDA forbids ``fork`` after its
    initialisation), and return the ranks' results in rank order.

    ``fn`` and ``args`` are pickled into the children, so ``fn`` is a
    module-level function of an importable module and its results are
    plain data.  The first rank to raise fails the whole run with its
    traceback, and the other ranks are killed; so is every rank once
    ``timeout_s`` has passed (each process group has the same timeout).
    On ``device="cuda"`` the kernels are built here, once, before any rank
    loads them."""
    from repro_torch.device import resolve_device

    world = shape[0] * shape[1]
    if world < 1:
        raise ValueError(f"mesh shape {shape} holds no rank")
    if resolve_device(device).type == "cuda":
        from repro_torch.kernels import build as KB

        KB.build()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got = {}
    with tempfile.TemporaryDirectory(prefix="xpk_mesh_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        # the job travels through a file: a large payload written down a
        # child's start-up pipe would start the ranks one after another
        job_path = os.path.join(tmp, "job.pkl")
        with open(job_path, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, tuple(shape), init, device, timeout_s,
                                   job_path, results))
                 for r in range(world)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout_s
            while len(got) < world:
                try:
                    rank, ok, payload = results.get(timeout=0.2)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"mesh {shape}: rank {dead[0]} died with exit "
                            f"code {procs[dead[0]].exitcode}")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"mesh {shape}: ranks {sorted(set(range(world)) - set(got))} "
                            f"gave no result within {timeout_s} s")
                    continue
                if not ok:
                    raise RuntimeError(f"mesh {shape}: rank {rank} failed:\n"
                                       f"{payload}")
                got[rank] = payload
            for p in procs:
                p.join(timeout=30)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [got[r] for r in range(world)]
