"""Rank functions of ``tests/test_torch_mesh.py`` for :func:`repro_torch.
launch.mesh.run_ranks`.

Spawned ranks import this module, not the test file, so they never import
JAX.  Each rank runs :func:`run_jobs` on the same list of jobs (plain
dicts) and returns one result per job:

* ``{"kind": "serve", ...}`` (the default) -- :func:`repro_torch.
  distributed.jobs.serve_job`;
* ``{"kind": "forward", ...}`` -- :func:`repro_torch.distributed.jobs.
  forward_job`, the full-sequence forward on the mesh;
* ``{"kind": "layer", ...}`` -- one decoder layer's sharded primitives
  (the column- and row-parallel linears, head-parallel decode attention,
  the head-parallel fused layer, dense and paged) on whole operands: each
  rank cuts its share, runs it, and the results are gathered back to
  whole tensors, to be held against one device;
* ``{"kind": "recalibrate", ...}`` -- GDC of a programmed tree cut over
  the model group; returns each state's gain;
* ``{"kind": "decode", ...}`` -- :func:`repro_torch.distributed.jobs.
  decode_job`, teacher-forced decode steps on the mesh;
* ``{"kind": "ep_local", ...}`` -- MoE's expert-parallel dispatch
  (``models/moe.py:_ep_local`` with the all-to-all over the model group)
  on each data rank's rows of given routing; the outputs are gathered
  back to the whole batch;
* ``{"kind": "train", ...}`` -- :func:`repro_torch.distributed.jobs.
  train_job`, training steps with the rank's cut of the state;
* ``{"kind": "launch", "arch", "kw"}`` -- :func:`repro_torch.distributed.
  jobs.launch_job`, the train launcher's rank function;
* ``{"kind": "front_door", ...}`` -- :func:`repro_torch.distributed.jobs.
  front_door_job`, the HTTP front door on rank 0, the other ranks
  following it;
* ``{"kind": "fail", "rank": r}`` -- rank ``r`` raises while the others
  wait in a collective (the failure path of ``run_ranks``);
* ``{"kind": "zero3", ...}`` -- one training loss and its backward on the
  rank's cut: how many ZeRO-3 gathers the forward made, how many of
  their results were still alive when it ended, and how many saved views
  the backward gathered again;
* ``{"kind": "restore", ...}`` -- a training checkpoint read with the
  rank's training placement: its ``(params, m, v)`` pieces.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import aimc_device as AD
from repro_torch import convert
from repro_torch import tree as TR
from repro_torch.distributed import jobs
from repro_torch.distributed.backend import ShardedBackend
from repro_torch.distributed.executor import Executor
from repro_torch.engine import get_backend
from repro_torch.kernels.plan import AttnSpec, KVView
from repro_torch.models import moe as M


def run_jobs(mesh, todo: List[Dict[str, Any]]) -> List[Any]:
    """Every job of ``todo`` on this rank, in order (see the module)."""
    kinds = {"serve": jobs.serve_job, "forward": jobs.forward_job,
             "decode": jobs.decode_job, "layer": layer_job,
             "recalibrate": recalibrate_job, "ep_local": ep_local_job,
             "train": jobs.train_job, "launch": jobs.launch_job,
             "front_door": jobs.front_door_job, "fail": fail_job,
             "zero3": zero3_job, "restore": restore_job}
    return [kinds[job.get("kind", "serve")](mesh, job) for job in todo]


def _gather_model(mesh, x: torch.Tensor, axis: int) -> torch.Tensor:
    """The whole tensor from each model rank's block along ``axis`` (a
    zero-filled buffer summed over the model group)."""
    axis = axis % x.dim()
    shape = list(x.shape)
    n = shape[axis]
    shape[axis] = n * mesh.model
    buf = torch.zeros(shape, dtype=torch.float32, device=x.device)
    buf.narrow(axis, mesh.model_index * n, n).copy_(x.to(torch.float32))
    return mesh.all_reduce_model(buf).to(x.dtype)


def _cut(mesh, x: torch.Tensor, axis: int) -> torch.Tensor:
    n = x.shape[axis] // mesh.model
    return x.narrow(axis, mesh.model_index * n, n).contiguous()


def layer_job(mesh, job):
    """``job``: ``cfg``, ``backend``, the whole layer's quantised operands
    ``ops`` (``{"wq": {"levels", "scale"}, ...}``, the keys of
    ``_fused_block_weights``: wq wk wv wo wi wo2), and numpy inputs:
    ``s [T,B,d]``, ``x_rows [T,B,H*hd]``, ``q [T,B,H,1,hd]``, ``k``/``v
    [T,B,H,L,hd]``, ``slot_keys [B,2]``, ``sk``/``sv [B,T,L,KV,hd]``,
    ``pos [B]``, ``kpool``/``vpool [P,T,KV,page_len,hd]``, ``table
    [B,MP]``, ``write_pids [B]``, and optionally ``wo_bias [d]`` (the
    row-parallel wo again with that bias).  Returns whole numpy outputs."""
    cfg, dev = job["cfg"], mesh.device
    hd = cfg.resolved_head_dim
    inner = get_backend(job["backend"])
    be = ShardedBackend(inner, mesh, cfg) if mesh.model > 1 else inner
    t = {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
         for k, v in job["inputs"].items()}
    whole = {"periods": {"blk0": {
        "mixer": {k: job["ops"][k] for k in ("wq", "wk", "wv", "wo")},
        "mlp": {"wi": job["ops"]["wi"], "wo": job["ops"]["wo2"]}}}}
    whole = convert.params_from_numpy(whole, dev)
    mine = convert.shard_params(whole, cfg, mesh.model, mesh.model_index)
    mine = mine["periods"]["blk0"]
    w = dict(mine["mixer"], wi=mine["mlp"]["wi"], wo2=mine["mlp"]["wo"])
    out = {}

    def gather(x, axis):
        return _gather_model(mesh, x, axis) if mesh.model > 1 else x

    for name in ("wq", "wi"):
        out[f"col_{name}"] = gather(
            be.spiking_linear(w[name], t["s"], part="col"), -1)
    rows = _cut(mesh, t["x_rows"], -1) if mesh.model > 1 else t["x_rows"]
    out["row_wo"] = be.spiking_linear(w["wo"], rows, part="row")
    if "wo_bias" in t:  # the row-parallel epilogue with a bias
        out["row_wo_b"] = be.spiking_linear(dict(w["wo"], b=t["wo_bias"]),
                                            rows, part="row")
    i_max = t["k"].shape[3]
    heads = (lambda x: _cut(mesh, x, 2)) if mesh.model > 1 else (lambda x: x)
    out["attn_dense"] = gather(be.decode_attention(
        KVView.dense(heads(t["k"]), heads(t["v"])), heads(t["q"]),
        AttnSpec(i_max=i_max), slot_keys=t["slot_keys"]), 2)
    kvc = (lambda x: _cut(mesh, x, 3)) if mesh.model > 1 else (lambda x: x)
    pool = heads
    ws = [w[k] for k in ("wq", "wk", "wv", "wo", "wi", "wo2")]
    for tail in (True, False):
        s1, kn, vn = be.decode_layer_fused(
            t["slot_keys"], t["s"], KVView.dense(kvc(t["sk"]), kvc(t["sv"])),
            t["pos"], *ws, hd=hd, with_tail=tail)
        sfx = "" if tail else "_notail"
        out["fused_dense" + sfx] = s1 if tail else gather(s1, -1)
        out["fused_dense_k" + sfx] = gather(kn, 2)
        out["fused_dense_v" + sfx] = gather(vn, 2)
    s1, kn, vn = be.decode_layer_fused(
        t["slot_keys"], t["s"],
        KVView.from_pool(pool(t["kpool"]), pool(t["vpool"]), t["table"]),
        t["pos"], *ws, hd=hd, write_pids=t["write_pids"])
    out["fused_paged"], out["fused_paged_k"], out["fused_paged_v"] = (
        s1, gather(kn, 2), gather(vn, 2))
    l = t["table"].shape[1] * t["kpool"].shape[3]
    out["attn_paged"] = gather(be.decode_attention(
        KVView.from_pool(pool(t["kpool"]), pool(t["vpool"]), t["table"]),
        heads(t["q"]), AttnSpec(i_max=l), slot_keys=t["slot_keys"]), 2)
    return {k: v.cpu().numpy() for k, v in out.items()}


def ep_local_job(mesh, job):
    """``job``: ``cfg``, numpy ``params`` (the MoE leaves, whole), ``x [B,
    S, d]``, the router's ``weights`` and ``idx [B, S, k]``.  Each rank
    holds its block of experts (``convert.shard_params``'s cut) and
    dispatches its data block of the rows -> the whole ``y`` and the
    rank's drops past ``cap`` and ``C2``."""
    cfg, dev = job["cfg"], mesh.device
    params = {k: torch.from_numpy(np.array(v)).to(dev)
              for k, v in job["params"].items()}
    params = {k: (v if k == "router" else convert._shard_experts(
        v, mesh.model, mesh.model_index, cfg.num_experts))
        for k, v in params.items()}
    b, s, d = job["x"].shape
    n = b // mesh.data
    rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)

    def mine(a):
        return torch.from_numpy(np.array(a[rows])).to(dev).reshape(n * s, -1)

    M.DISPATCH.reset()
    y = M._ep_local(mine(job["x"]), mine(job["weights"]),
                    mine(job["idx"]).long(), params, cfg,
                    M.ParallelCtx(mesh))
    drops = M.DISPATCH.read()
    M.DISPATCH.reset(enabled=False)
    whole = torch.zeros((b * s, d), dtype=y.dtype, device=dev)
    whole[mesh.data_index * n * s:(mesh.data_index + 1) * n * s] = y
    return {"y": mesh.all_reduce_data(whole).reshape(b, s, d).numpy(),
            "drops": drops}


# ---------------------------------------------------------------------------
# GDC of a sharded tree; the failure path
# ---------------------------------------------------------------------------


def recalibrate_job(mesh, job):
    """``job``: ``cfg``, ``tree`` (a whole programmed tree as numpy),
    ``aimc_cfg``.  Returns each state's GDC gain, in tree order."""
    tree = convert.params_from_numpy(job["tree"], mesh.device)
    ex = Executor(tree, job["cfg"], "integer", mesh)
    got = AD.recalibrate_tree(ex.params, job["aimc_cfg"], ex.gdc_reduce)
    return [s.gdc_gain.cpu().numpy() for s in AD.device_states(got)]


def fail_job(mesh, job):
    if mesh.rank == job["rank"]:
        raise RuntimeError(f"rank {mesh.rank} fails on purpose")
    x = torch.zeros(1, device=mesh.host_device)
    torch.distributed.all_reduce(x)  # waits for the rank that failed
    return None


def zero3_job(mesh, job):
    """See the module: the counts of :data:`repro_torch.launch.mesh.
    ZERO3` over one loss and its backward, and the gathered tensors alive
    between them (``live``)."""
    from repro_torch import prng
    from repro_torch.configs import ParallelConfig
    from repro_torch.launch import mesh as MESH
    from repro_torch.optim import adamw as A
    from repro_torch.train import loop as TL

    cfg = job["cfg"]
    parallel = ParallelConfig(**job.get("parallel", {}))
    params, _ = TL.rank_state(cfg, mesh, parallel, A.AdamWConfig(),
                              convert.params_from_numpy(job["params"],
                                                        mesh.device))
    leaves, structure = TR.flatten(params)
    live = [x.detach().requires_grad_(True) for x in leaves]
    loss_f = TL.mesh_loss(cfg, parallel, mesh)
    batch = {"tokens": torch.from_numpy(job["tokens"])}
    MESH.ZERO3.update(gathers=0, regathers=0)
    with torch.enable_grad():
        loss, _ = loss_f(TR.unflatten(structure, live), batch,
                         prng.fold_in(prng.PRNGKey(0), 0))
        alive = len(MESH._GATHERED)
        gathers = MESH.ZERO3["gathers"]
        torch.autograd.grad(loss, live, allow_unused=True)
    return {"gathers": gathers, "live": alive,
            "regathers": MESH.ZERO3["regathers"]}


def restore_job(mesh, job):
    """See the module."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ParallelConfig
    from repro_torch.optim import adamw as A
    from repro_torch.train import loop as TL

    cfg = job["cfg"]
    parallel = ParallelConfig(**job.get("parallel", {}))
    opt = A.AdamWConfig()
    (params, state), step = CheckpointManager(job["ckpt"]).restore(
        TL.whole_like(cfg, opt, parallel),
        placement=TL.state_placement(cfg, mesh, parallel))
    return {"step": step, "params": convert.params_to_numpy(params),
            "m": convert.params_to_numpy(state["m"]),
            "v": convert.params_to_numpy(state["v"])}
