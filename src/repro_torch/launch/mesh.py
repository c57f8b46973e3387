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

Training on the mesh moves gradients through the collectives, so each has
an autograd form (:class:`torch.autograd.Function`) whose backward is the
transposed collective.  Two conventions meet there.  Over ``model`` the
activations outside a cut are *replicated*: every rank of a model group
holds the same tensor and, in the backward, the same cotangent of it.
Over ``data`` each rank holds its own rows, and the cotangents of a
gathered tensor differ by rank.  Hence:

* :meth:`ServingMesh.copy_to_model` -- identity forward, sum over the
  model group backward (Megatron's ``f``: the input of a column-parallel
  part, whose ranks each give a partial cotangent);
* :meth:`ServingMesh.reduce_from_model` -- sum over the model group
  forward, identity backward (``g``: the output of a row-parallel part);
  :meth:`ServingMesh.reduce_tokens` is the same over the ranks that split
  a batch's tokens (the router's statistics);
* :meth:`ServingMesh.split_model` -- the rank's block forward, the
  blocks gathered backward (a replicated tensor cut into sequence blocks);
* :meth:`ServingMesh.all_gather` -- over ``model`` its backward takes the
  rank's own block of the cotangent (the cotangents are equal: what
  follows is replicated); over ``data`` it is a reduce-scatter (each data
  rank's cotangent is its own rows' contribution, and the block's
  gradient is their sum);
* :meth:`ServingMesh.reduce_scatter_data` -- ``lax.psum_scatter``'s
  twin, the all-gather backward.  Gloo has no reduce-scatter, so under
  gloo it is an all-to-all of the blocks and a sum of the received blocks
  in rank order (the bytes of a reduce-scatter, and the same sum on every
  rank); under NCCL ``reduce_scatter_tensor``;
* :meth:`ServingMesh.reduce_scatter_model` -- the same over ``model``
  (partial sums whose columns the ranks split), the cotangents' blocks
  gathered backward;
* :meth:`ServingMesh.gather_data_freed` -- ZeRO-3's gather of a
  ``data``-cut weight, backward the reduce-scatter of its gradient; inside
  :func:`regathered_saves` autograd keeps the rank's block, not the whole
  weight, for the backward, and gathers it again there;
* :meth:`ServingMesh.all_to_all_model` -- its own transpose.

Under gloo the gathers and all-to-alls run on CPU tensors (the operand
goes through :attr:`ServingMesh.host_device`); sums stay ``all_reduce``.
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
import weakref
from typing import Any, Callable, List, Optional, Sequence, Tuple

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
        all-to-all on CPU tensors only).  Its backward is the same
        all-to-all.  The identity at ``model = 1``."""
        if self.model <= 1:
            return x
        return _AllToAll.apply(x, self, "model")

    # -- collectives that carry gradients (see the module) --------------

    def axis_size(self, axis: str) -> int:
        """The ranks of ``axis`` (``"data"`` or ``"model"``)."""
        return self._group(axis)[1]

    def _group(self, over: str):
        """``(process group, size, this rank's index)`` of ``over``."""
        if over == "model":
            return self.model_group, self.model, self.model_index
        if over == "data":
            return self.data_group, self.data, self.data_index
        raise ValueError(f"over must be 'model' or 'data', not {over!r}")

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward; the cotangent summed over the model group."""
        if self.model <= 1:
            return x
        return _SumBackward.apply(x, self, ("model",))

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the model group; identity backward."""
        if self.model <= 1:
            return x
        return _SumForward.apply(x, self, ("model",))

    def reduce_tokens(self, x: torch.Tensor, over=("data", "model")
                      ) -> torch.Tensor:
        """The sum over the groups ``over`` (the ranks that split a batch's
        tokens); identity backward: each rank's share of a replicated
        result gets the result's cotangent."""
        over = tuple(a for a in over if self._group(a)[1] > 1)
        if not over:
            return x
        return _SumForward.apply(x, self, over)

    def split_model(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """This rank's block of ``axis`` (``model`` equal blocks); the
        blocks' cotangents gathered backward."""
        if self.model <= 1:
            return x
        return _Split.apply(x, self, axis)

    def all_gather(self, x: torch.Tensor, axis: int, over: str
                   ) -> torch.Tensor:
        """The group's blocks of ``axis`` concatenated in rank order
        (``lax.all_gather(x, over, axis=axis, tiled=True)``).  Backward:
        over ``model`` the rank's own block of the cotangent (the
        cotangents of the ranks are equal), over ``data`` the
        reduce-scatter of the cotangents (they differ by rank)."""
        if self._group(over)[1] <= 1:
            return x
        return _Gather.apply(x, self, axis, over)

    def reduce_scatter_data(self, x: torch.Tensor, axis: int
                            ) -> torch.Tensor:
        """The sum over the data group of ``x``, of which this rank keeps
        its block of ``axis`` (``lax.psum_scatter(x, "data",
        scatter_dimension=axis, tiled=True)``); the all-gather backward."""
        if self.data <= 1:
            return x
        return _ReduceScatter.apply(x, self, axis, "data")

    def reduce_scatter_model(self, x: torch.Tensor, axis: int
                             ) -> torch.Tensor:
        """The sum over the model group of ``x`` (each rank's partial
        sums), of which this rank keeps its block of ``axis``
        (``lax.psum_scatter`` over ``model``); the all-gather of the
        cotangent's blocks backward."""
        if self.model <= 1:
            return x
        return _ReduceScatter.apply(x, self, axis, "model")

    def gather_data_freed(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """ZeRO-3's un-cut: the data group's blocks of ``axis`` gathered
        (:meth:`all_gather` over ``data``: the gradient reduce-scattered
        back), the whole tensor marked so that, inside
        :func:`regathered_saves`, autograd saves the rank's block in its
        place and gathers it again in the backward: a layer's whole
        weights live only while the layer runs."""
        if self.data <= 1:
            return x
        return _GatherFreed.apply(x, self, axis)

    def all_reduce(self, x: torch.Tensor, over=("data", "model"),
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In place: ``x`` reduced (``op``) over each group of ``over`` in
        turn (no gradient)."""
        for a in over:
            group, size, _ = self._group(a)
            if size > 1:
                dist.all_reduce(x, op=op, group=group)
        return x

    def all_reduce_data(self, x: torch.Tensor) -> torch.Tensor:
        """In place: the sum of ``x`` over the data group."""
        if self.data > 1:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.data_group)
        return x

    def barrier(self) -> None:
        """Wait until every rank of the mesh reaches this point."""
        if self.data * self.model > 1:
            dist.barrier()

    def broadcast_float(self, x: float) -> float:
        """Global rank 0's value of ``x`` on every rank."""
        if self.data * self.model == 1:
            return x
        t = torch.tensor([x], dtype=torch.float64, device=self.host_device)
        dist.broadcast(t, src=0)
        return float(t[0])

    def broadcast_bytes(self, payload: Optional[bytes]) -> bytes:
        """Global rank 0's ``payload`` on every rank (the others pass
        ``None``): its length, then its bytes in a uint8 tensor, each one
        broadcast staged through :attr:`host_device`.  Any thread may call
        it, as long as one thread a rank issues the mesh's collectives."""
        if self.data * self.model == 1:
            return payload
        lead = self.rank == 0
        n = torch.tensor([len(payload) if lead else 0], dtype=torch.int64,
                         device=self.host_device)
        dist.broadcast(n, src=0)
        buf = (torch.frombuffer(bytearray(payload), dtype=torch.uint8)
               .to(self.host_device) if lead else
               torch.empty(int(n[0]), dtype=torch.uint8,
                           device=self.host_device))
        dist.broadcast(buf, src=0)
        return payload if lead else buf.cpu().numpy().tobytes()


# ---------------------------------------------------------------------------
# The collectives' autograd forms (eager functions first)
# ---------------------------------------------------------------------------


def _gather(x: torch.Tensor, mesh: ServingMesh, axis: int, over: str
            ) -> torch.Tensor:
    group, size, _ = mesh._group(over)
    axis = axis % x.dim()
    src = x.detach().movedim(axis, 0).contiguous()
    if mesh.backend == "nccl":
        out = torch.empty((size * src.shape[0],) + src.shape[1:],
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=group)
    else:
        host = src.to(mesh.host_device)
        parts = [torch.empty_like(host) for _ in range(size)]
        dist.all_gather(parts, host, group=group)
        out = torch.cat(parts).to(x.device)
    return out.movedim(0, axis)


def _block(x: torch.Tensor, axis: int, size: int, index: int
           ) -> torch.Tensor:
    n = x.shape[axis] // size
    return x.narrow(axis, index * n, n).contiguous()


def _reduce_scatter(x: torch.Tensor, mesh: ServingMesh, axis: int,
                    over: str = "data") -> torch.Tensor:
    group, size, _ = mesh._group(over)
    axis = axis % x.dim()
    if x.shape[axis] % size:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split "
                         f"over {over}={size}")
    src = x.detach().movedim(axis, 0).contiguous()
    n = src.shape[0] // size
    if mesh.backend == "nccl":
        out = torch.empty((n,) + src.shape[1:], dtype=src.dtype,
                          device=src.device)
        dist.reduce_scatter_tensor(out, src, group=group)
    else:
        # gloo: the blocks all-to-all, then their sum in rank order
        host = src.to(mesh.host_device)
        got = torch.empty_like(host)
        dist.all_to_all_single(got, host, group=group)
        parts = got.view(size, n, *src.shape[1:])
        out = parts[0].clone()
        for r in range(1, size):
            out += parts[r]
        out = out.to(x.device)
    return out.movedim(0, axis)


def _all_to_all(x: torch.Tensor, mesh: ServingMesh, over: str
                ) -> torch.Tensor:
    group = mesh._group(over)[0]
    src = x.detach().to(mesh.host_device).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device)


# the tensors :class:`_GatherFreed` made, by storage address (a weak
# reference: an entry lives only as long as its tensor, so an address that
# a later tensor reuses is never mistaken for a gathered one)
_GATHERED: "weakref.WeakValueDictionary[int, torch.Tensor]" = \
    weakref.WeakValueDictionary()
# ZeRO-3's gathers since the caller last zeroed them: ``gathers`` in the
# forward, ``regathers`` of saved views in the backward
ZERO3 = {"gathers": 0, "regathers": 0}


@dataclasses.dataclass(frozen=True)
class _Regather:
    """What a saved view of a gathered tensor is rebuilt from."""

    piece: torch.Tensor
    mesh: ServingMesh
    axis: int
    size: Tuple[int, ...]
    stride: Tuple[int, ...]
    offset: int


def _pack(t: torch.Tensor):
    whole = _GATHERED.get(t.untyped_storage().data_ptr())
    if whole is None:
        return t
    piece, mesh, axis = whole._regather
    return _Regather(piece, mesh, axis, tuple(t.size()), tuple(t.stride()),
                     t.storage_offset())


def _unpack(saved):
    if not isinstance(saved, _Regather):
        return saved
    # the same gather of the same block: the same layout, so the saved
    # view's strides and offset address the same elements
    ZERO3["regathers"] += 1
    whole = _gather(saved.piece, saved.mesh, saved.axis, "data")
    return whole.as_strided(saved.size, saved.stride, saved.offset)


def regathered_saves():
    """A context in which autograd saves, for any tensor that views a
    :meth:`ServingMesh.gather_data_freed` result, the rank's block instead,
    and gathers it again when the backward reads it (ZeRO-3 without
    keeping every layer's whole weights through the step).  Every rank
    runs the same graph, so the backward's gathers meet in the same
    order."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, over):
        return mesh.all_reduce(x.detach().clone(), over)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, over):
        ctx.mesh, ctx.over = mesh, over
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.over), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _block(x.detach(), axis, mesh.model, mesh.model_index)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axis, "model"), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, over):
        ctx.mesh, ctx.axis, ctx.over = mesh, axis, over
        return _gather(x, mesh, axis, over)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        if ctx.over == "model":
            gx = _block(g, ctx.axis, mesh.model, mesh.model_index)
        else:
            gx = _reduce_scatter(g, mesh, ctx.axis)
        return gx, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, over):
        ctx.mesh, ctx.axis, ctx.over = mesh, axis, over
        return _reduce_scatter(x, mesh, axis, over)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axis, ctx.over), None, None, None


class _GatherFreed(torch.autograd.Function):
    """ZeRO-3's gather over ``data``: forward the gather, its result
    registered so that :func:`regathered_saves` keeps no copy of it for
    the backward; backward the reduce-scatter of the cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        out = _gather(x, mesh, axis, "data")
        ZERO3["gathers"] += 1
        _GATHERED[out.untyped_storage().data_ptr()] = out
        out._regather = (x.detach(), mesh, axis)
        return out

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.axis), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, over):
        ctx.mesh, ctx.over = mesh, over
        return _all_to_all(x, mesh, over)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.mesh, ctx.over), None, None


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
              timeout_s: float = DEFAULT_TIMEOUT_S,
              wait_s: Optional[float] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on each rank of a ``shape`` mesh, one
    spawned process per rank (CUDA forbids ``fork`` after its
    initialisation), and return the ranks' results in rank order.

    ``fn`` and ``args`` are pickled into the children, so ``fn`` is a
    module-level function of an importable module and its results are
    plain data.  The first rank to raise fails the whole run with its
    traceback, and the other ranks are killed; so is every rank once
    ``wait_s`` (default ``timeout_s``; ``math.inf``: a server's ranks,
    which end when it stops) has passed.  Each process group has the
    timeout ``timeout_s``.
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
            wait_s = timeout_s if wait_s is None else wait_s
            deadline = time.monotonic() + wait_s
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
                            f"gave no result within {wait_s} s")
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
