"""Rank functions for :func:`repro_torch.launch.mesh.run_ranks`.

Each rank of a mesh runs :func:`run_jobs` on the same list of jobs (plain
dicts, so the spawned ranks import nothing but the port) and returns one
result per job.  Each builds the params (a whole tree given as numpy,
:func:`repro_torch.convert.params_to_numpy`; a training checkpoint's,
``ckpt`` its directory, read with the rank's serving placement; or random
weights from ``init_seed``, which ``program_seed`` programs onto PCM
first, and of whose MoE leaves a rank of a model group draws only its
block of experts) and an :class:`~repro_torch.distributed.Executor`,
then:

* a serve job (``kind`` ``"serve"``, the default) serves ``prompts``,
  optionally in waves (``wave`` requests every ``gap`` steps) after a
  warm-up; the result holds the token streams, the
  :class:`~repro_torch.serving.ServeStats`, per-request energy, the
  kernel launches of the measured run (counted from zero), what its MoE
  dispatches did (:data:`repro_torch.models.moe.DISPATCH`) and the
  weights the rank holds; with ``check_tokens`` (numpy ``[B, S]``), also
  whether the served tree's ``Executor.forward`` logits on them are all
  finite, read after the measured run;
* a forward job (``"forward"``) runs ``Executor.forward`` on ``tokens``
  (numpy ``[B, S]``; a frontend arch: ``embeddings [B, S, F]``) with
  ``PRNGKey(key_seed)``, after a warm-up forward
  when ``warmup`` is set; the result holds the logits (numpy), the wall
  seconds and the launches of the measured forward;
* a decode job (``"decode"``) runs ``steps`` teacher-forced decode steps
  of ``tokens`` (numpy ``[B, S]``, one slot a row, the slots split over
  ``data``) through the executor's share and ``pctx``; the result holds
  each step's logits gathered over ``data`` (numpy ``[B, steps, V]``) and
  each step's MoE drops;
* a train job (``"train"``) takes ``steps`` steps of
  :func:`repro_torch.train.loop.make_train_step` on the mesh, the rank
  holding its cut of the state: the whole ``params`` given as numpy (cut
  here) or drawn from ``init_seed`` (each rank drawing only its cut), a
  ``parallel`` and ``opt`` dict of :class:`repro_torch.configs.
  ParallelConfig` and ``AdamWConfig`` fields, and each step's batch
  ``tokens`` (numpy ``[B, S+1]``, every step) or ``MarkovStream``'s
  ``batch_at(step)`` of ``data = (batch, seq_len, seed)``, keyed
  ``fold_in(PRNGKey(key_seed), step)``.  The result holds each step's
  metrics, seconds and MoE dispatches (forward only: the backward moves
  the same bytes back), with ``probe`` the loss on step 0's batch before
  and after, and with ``return_state`` the rank's final cut of the
  parameters and moments (numpy);
* a launch job (``"launch"``) runs the train launcher's rank function
  (:func:`repro_torch.launch.train._rank_train`) for ``arch`` with the
  keywords ``kw``; the result is its report.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import torch

from repro_torch import aimc_device as AD
from repro_torch import convert, prng
from repro_torch import tree as TR
from repro_torch.distributed.executor import Executor
from repro_torch.kernels import build as KB
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH


def run_jobs(mesh, jobs: List[Dict[str, Any]]) -> List[Any]:
    """Every job of ``jobs`` on this rank, in order (see the module);
    each result also holds ``job_s``, the job's wall seconds (its set-up
    included), and on the card ``max_memory_allocated``, the job's peak."""
    kinds = {"serve": serve_job, "forward": forward_job,
             "decode": decode_job, "train": train_job,
             "launch": launch_job}
    cuda = mesh.device.type == "cuda"
    out = []
    for job in jobs:
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        res = kinds[job.get("kind", "serve")](mesh, job)
        if cuda:
            torch.cuda.synchronize()
            res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            torch.cuda.empty_cache()  # the job's tree is gone
        out.append(dict(res, job_s=time.perf_counter() - t0))
    return out


def _restored(job, mesh):
    """The parameters of the newest checkpoint of a training run in
    ``job["ckpt"]`` (``repro_torch.launch.train``'s ``(params,
    opt_state)``, float32 moments), each leaf read as this rank's serving
    placement holds it (:func:`repro_torch.launch.elastic.
    state_shardings`: a float linear whole, to be quantised before it is
    cut); the optimizer state is not read."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import elastic
    from repro_torch.optim import adamw as A

    cfg = job["cfg"]
    opt = A.AdamWConfig()
    whole = T.init_params(cfg, 0, "cpu")
    placement = elastic.state_shardings(cfg, mesh.shape, opt,
                                        device=mesh.device, rank=mesh.rank,
                                        serving=True)
    (params, _), _ = CheckpointManager(job["ckpt"]).restore(
        (whole, A.init_opt_state(whole, opt)), placement=placement)
    return params


def _params(job, mesh):
    """The tree: given, from a checkpoint, or random from ``init_seed``
    (then programmed with ``PRNGKey(program_seed)`` if that is set), a
    float MoE's experts drawn as the rank's block when ``model > 1``, so
    that no rank holds every expert of a full-width config."""
    device = mesh.device
    if job.get("params") is not None:
        return convert.params_from_numpy(job["params"], device)
    if job.get("ckpt") is not None:
        return _restored(job, mesh)
    share = (mesh.model_index, mesh.model) if mesh.model > 1 else None
    params = T.init_params(job["cfg"], job["init_seed"], device, share)
    if job.get("program_seed") is not None:
        params = AD.program_lm_tree(
            prng.PRNGKey(job["program_seed"], device), params,
            job.get("aimc_cfg") or AD.AIMCConfig())
    return params


def drive(sch, prompts, max_new: int, seed0: int, wave: int = 0,
          gap: int = 0):
    """Submit ``wave`` requests every ``gap`` steps (all at once when
    ``wave`` is 0), request ``i`` on stream ``seed0 + i``, then serve to
    the end; returns the streams in request order and the wall seconds."""
    wave = wave or len(prompts)
    rids = []
    t0 = time.perf_counter()
    for i in range(0, len(prompts), wave):
        rids += [sch.submit(p, max_new, seed=seed0 + i + j)
                 for j, p in enumerate(prompts[i:i + wave])]
        for _ in range(gap):
            sch.step()
    out = sch.run()
    if sch.device.type == "cuda":
        torch.cuda.synchronize()
    return [out[r] for r in rids], time.perf_counter() - t0


def serve_job(mesh, job):
    cfg = job["cfg"]
    ex = Executor(_params(job, mesh), cfg, job.get("backend", "cuda"), mesh)
    sch = ex.scheduler(slots=job["slots"], cache_len=job["cache_len"],
                       drift=job.get("drift"), paged=job.get("paged", False),
                       page_len=job.get("page_len", 8),
                       decode_kernel=job.get("decode_kernel", "auto"))
    args = (job["max_new"], job.get("seed0", 0), job.get("wave", 0),
            job.get("gap", 0))
    if job.get("warmup"):
        drive(sch, job["prompts"][:2], 4, *args[1:])
        sch.reset()
    KB.reset_launches()
    M.DISPATCH.reset()
    outs, wall_s = drive(sch, job["prompts"], *args)
    moe = M.DISPATCH.read()
    M.DISPATCH.reset(enabled=False)
    res = {"outputs": outs, "stats": dataclasses.asdict(sch.stats),
           "params": sum(x.numel() for x in TR.flatten(ex.params)[0]
                         if isinstance(x, torch.Tensor)),
           "wall_s": wall_s, "launches": dict(KB.LAUNCHES),
           "request_energy_j": [sch.request_energy_j[r]
                                for r in sorted(sch.request_energy_j)],
           "fused": bool(sch.plan and sch.plan.fused),
           "backend": sch.backend.name, "moe": moe}
    if job.get("check_tokens") is not None:  # after the measured run
        logits = ex.forward(torch.from_numpy(job["check_tokens"]))
        res["logits_finite"] = bool(torch.isfinite(logits).all())
    return res


def forward_job(mesh, job):
    ex = Executor(_params(job, mesh), job["cfg"],
                  job.get("backend", "cuda"), mesh)
    tokens = ({"embeddings": torch.from_numpy(job["embeddings"])}
              if "embeddings" in job else torch.from_numpy(job["tokens"]))
    key = prng.PRNGKey(job["key_seed"], mesh.device)
    if job.get("warmup"):
        ex.forward(tokens, key)
    KB.reset_launches()
    t0 = time.perf_counter()
    logits = ex.forward(tokens, key)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    return {"logits": logits.cpu().numpy(),
            "wall_s": time.perf_counter() - t0,
            "launches": dict(KB.LAUNCHES), "backend": ex.backend.name}


def decode_job(mesh, job):
    """Teacher-forced decode steps on the mesh (see the module): each data
    rank decodes its block of the rows, a MoE block routing them over the
    model group with the executor's ``pctx``."""
    cfg = job["cfg"]
    ex = Executor(_params(job, mesh), cfg, job.get("backend", "cuda"), mesh)
    tokens = torch.from_numpy(job["tokens"]).to(mesh.device)
    b, steps = tokens.shape[0], job.get("steps", tokens.shape[1])
    own = SH.slot_range(b, mesh.data, mesh.data_index)
    cache = T.init_cache(cfg, len(own), steps, mesh.device,
                         SH.local_kv_heads(cfg, mesh.model))
    seeds = torch.arange(own.start, own.stop, device=mesh.device)
    logits, drops = [], []
    for i in range(steps):
        M.DISPATCH.reset()
        out, cache = T.decode_step(
            ex.params, cache, tokens[own.start:own.stop, i:i + 1], cfg,
            backend=ex.backend, seeds=seeds, pctx=ex.pctx)
        drops.append(M.DISPATCH.read())
        logits.append(ex._gather_rows(out, own.start, b))
    M.DISPATCH.reset(enabled=False)
    return {"logits": torch.cat(logits, 1).float().cpu().numpy(),
            "drops": drops}


def train_job(mesh, job):
    """Training steps on the mesh, each rank on its cut (see the
    module)."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.data.pipeline import DataConfig, MarkovStream
    from repro_torch.optim import adamw as A
    from repro_torch.train import loop as TL

    cfg, dev = job["cfg"], mesh.device
    parallel = ParallelConfig(**job.get("parallel", {}))
    opt = A.AdamWConfig(**job.get("opt", {}))
    if job.get("params") is not None:
        params, state = TL.rank_state(
            cfg, mesh, parallel, opt,
            convert.params_from_numpy(job["params"], dev))
    else:
        params, state = TL.init_state(job["init_seed"], cfg, opt, parallel,
                                      device=dev, mesh=mesh)
    if job.get("tokens") is not None:
        fixed = {"tokens": torch.from_numpy(job["tokens"]).to(dev)}
        batch_at = lambda step: fixed  # noqa: E731
    else:
        b, s, seed = job["data"]
        batch_at = MarkovStream(DataConfig(cfg.vocab_size, s, b, seed=seed),
                                device=dev).batch_at
    step_fn = TL.make_train_step(cfg, parallel, opt, mesh=mesh,
                                 donate=True)
    key = prng.PRNGKey(job.get("key_seed", 0))
    cuda = dev.type == "cuda"
    out: Dict[str, Any] = {"metrics": [], "step_s": [], "dispatch": []}
    probe = TL.mesh_loss(cfg, parallel, mesh) if job.get("probe") else None
    probe_key = prng.PRNGKey(job.get("key_seed", 0) + 555, dev)
    if probe is not None:
        with torch.no_grad():
            out["probe_before"] = float(probe(params, batch_at(0),
                                              probe_key)[0])
    for step in range(job.get("steps", 1)):
        batch = batch_at(step)
        M.DISPATCH.reset()
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batch,
                                         prng.fold_in(key, step))
        if cuda:
            torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["dispatch"].append(M.DISPATCH.read())
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
    M.DISPATCH.reset(enabled=False)
    if probe is not None:
        with torch.no_grad():
            out["probe_after"] = float(probe(params, batch_at(0),
                                             probe_key)[0])
    out["held"] = sum(x.numel() for x in TR.flatten(params)[0])
    if job.get("return_state"):
        out["params"] = convert.params_to_numpy(params)
        out["m"] = convert.params_to_numpy(state["m"])
        out["v"] = convert.params_to_numpy(state["v"])
    return out


def launch_job(mesh, job):
    from repro_torch.launch import train as LT

    return LT._rank_train(mesh, job["arch"], job["kw"])
