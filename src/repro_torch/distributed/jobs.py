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
  keywords ``kw``; the result is its report;
* a front door job (``"front_door"``) serves through
  :class:`~repro_torch.server.FrontDoor` on rank 0 over a
  :class:`~repro_torch.server.mesh.MeshLeader`, every other rank
  following it (:func:`repro_torch.server.mesh.follow`): see
  :func:`front_door_job`.

A serve or front door job's ``trace_out`` (a JSONL path) and
``profile_steps`` (with ``profile_dir``) attach a telemetry bundle to
rank 0's scheduler only: the other ranks hold none.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import signal
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
             "launch": launch_job, "front_door": front_door_job}
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


def _scheduler(mesh, job):
    """The rank's executor and scheduler of a serve or front door job,
    warmed up on the job's first two prompts when ``warmup`` is set."""
    ex = Executor(_params(job, mesh), job["cfg"], job.get("backend", "cuda"),
                  mesh)
    sch = ex.scheduler(slots=job["slots"], cache_len=job["cache_len"],
                       drift=job.get("drift"), paged=job.get("paged", False),
                       page_len=job.get("page_len", 8),
                       decode_kernel=job.get("decode_kernel", "auto"))
    if job.get("warmup"):
        drive(sch, job["prompts"][:2], 4, job.get("seed0", 0),
              job.get("wave", 0), job.get("gap", 0))
        sch.reset()
    return ex, sch


def _telemetry(job):
    """Rank 0's telemetry bundle: a JSONL sink on ``trace_out`` and a
    ``profile_steps``-step profiler window, where the job asks for them
    -> (bundle, the sink or None)."""
    from repro_torch.obs import JsonlSink, StepProfiler, Telemetry

    prof = (StepProfiler(job["profile_steps"], job["profile_dir"])
            if job.get("profile_steps") else None)
    obs = Telemetry.create(profiler=prof)
    sink = JsonlSink(job["trace_out"]) if job.get("trace_out") else None
    if sink is not None:
        obs.tracer.add_sink(sink)
    return obs, sink


def _served(ex, sch, moe) -> Dict[str, Any]:
    """What every rank of a serve or front door job returns about its
    scheduler's run."""
    return {"stats": dataclasses.asdict(sch.stats),
            "params": sum(x.numel() for x in TR.flatten(ex.params)[0]
                          if isinstance(x, torch.Tensor)),
            "launches": dict(KB.LAUNCHES),
            "request_energy_j": [sch.request_energy_j[r]
                                 for r in sorted(sch.request_energy_j)],
            "fused": bool(sch.plan and sch.plan.fused),
            "backend": sch.backend.name, "moe": moe,
            "telemetry": sch.obs is not None}


def serve_job(mesh, job):
    ex, sch = _scheduler(mesh, job)
    sink = None
    if mesh.rank == 0 and (job.get("trace_out") or job.get("profile_steps")):
        obs, sink = _telemetry(job)
        sch.attach_obs(obs)
    KB.reset_launches()
    M.DISPATCH.reset()
    try:
        outs, wall_s = drive(sch, job["prompts"], job["max_new"],
                             job.get("seed0", 0), job.get("wave", 0),
                             job.get("gap", 0))
    finally:
        if sink is not None:
            sink.close()
    moe = M.DISPATCH.read()
    M.DISPATCH.reset(enabled=False)
    res = dict(_served(ex, sch, moe), outputs=outs, wall_s=wall_s)
    if job.get("check_tokens") is not None:  # after the measured run
        logits = ex.forward(torch.from_numpy(job["check_tokens"]))
        res["logits_finite"] = bool(torch.isfinite(logits).all())
    return res


def front_door_job(mesh, job):
    """The front door on the mesh.  Every rank builds its scheduler as a
    serve job does (``cfg``, ``slots``, ``cache_len``, ``paged``, ...).
    Rank 0 wraps it in a :class:`~repro_torch.server.mesh.MeshLeader`
    (heartbeat every ``heartbeat_s``) under a
    :class:`~repro_torch.server.FrontDoor` with the ``tenants`` policies
    (``{name: TenantPolicy fields}``) and the job's telemetry, and serves
    :class:`~repro_torch.server.HttpFrontDoor`:

    * with ``http = (host, port)``, until SIGINT (the serve CLI's
      ``--http`` on a mesh; the other ranks ignore SIGINT), then stops the
      front door, which stops the followers;
    * else on 127.0.0.1 and a free port, where it posts ``prompts``
      (request ``i`` on seed ``seed0 + i`` as tenant ``i % len(tenants)``
      of the ``tenants`` in order, ``max_new`` new tokens) in the waves of
      ``waves`` (request counts; all at once by default), idle for
      ``idle_s`` between two waves; a tenant of ``refill_on_preempt``
      (``{name: J/s}``) refills its joule bucket at that rate once its
      first preemption is recorded.  After the last stream it scrapes
      ``/metrics`` and ``/stats`` and stops.

    The other ranks follow rank 0 (:func:`repro_torch.server.mesh.
    follow`).  Every rank returns its scheduler's ``outputs`` (rid ->
    tokens), ``ServeStats``, request energies and launches, and whether it
    holds telemetry; rank 0 also the streams, their ``done`` payloads and
    errors, the front door's results and admission records, its trace
    events, the scrapes, the makespan and the idle gap's seconds and
    steps; a follower what it followed."""
    from repro_torch.server import FrontDoor, TenantPolicy
    from repro_torch.server import mesh as SM

    ex, sch = _scheduler(mesh, job)
    KB.reset_launches()
    M.DISPATCH.reset()
    t0 = time.perf_counter()
    if mesh.rank != 0:
        if job.get("http") is not None:
            # Ctrl-C reaches every rank of a terminal's process group: rank
            # 0 turns it into the stop that ends the followers
            signal.signal(signal.SIGINT, signal.SIG_IGN)
        res: Dict[str, Any] = {"followed": SM.follow(sch, mesh)}
    else:
        obs, sink = _telemetry(job)
        front = FrontDoor(
            SM.MeshLeader(sch, mesh, job.get("heartbeat_s", SM.HEARTBEAT_S)),
            telemetry=obs, policies={
                name: TenantPolicy(**kw)
                for name, kw in job.get("tenants", {}).items()})
        try:
            res = asyncio.run(_until_interrupted(front, mesh, *job["http"])
                              if job.get("http") is not None
                              else _post(front, job))
        finally:
            if sink is not None:
                sink.close()
    moe = M.DISPATCH.read()
    M.DISPATCH.reset(enabled=False)
    return dict(res, **_served(ex, sch, moe),
                outputs={r: list(t) for r, t in sch.outputs.items()},
                wall_s=time.perf_counter() - t0)


async def _until_interrupted(front, mesh, host: str, port: int
                             ) -> Dict[str, Any]:
    """Serve HTTP until SIGINT (ignored from then on), then stop."""
    from repro_torch.server import HttpFrontDoor

    loop = asyncio.get_running_loop()
    interrupted = asyncio.Event()
    loop.add_signal_handler(signal.SIGINT, interrupted.set)
    try:
        async with HttpFrontDoor(front, host=host, port=port) as srv:
            print(f"[serve] HTTP front door on http://{srv.host}:{srv.port} "
                  f"(POST /generate, GET /stats, GET /metrics, GET "
                  f"/healthz), rank 0 of a (data={mesh.data}, "
                  f"model={mesh.model}) mesh; Ctrl-C to stop", flush=True)
            # until Ctrl-C, or a pump that failed (a rank died): stopping
            # then raises its exception
            waits = [asyncio.ensure_future(interrupted.wait()),
                     asyncio.ensure_future(front.wait())]
            try:
                await asyncio.wait(waits, return_when=asyncio.FIRST_COMPLETED)
            finally:
                for w in waits:
                    w.cancel()
    finally:
        # the run is ending: a second Ctrl-C (torchrun forwards the one it
        # got) must not cut it short
        loop.remove_signal_handler(signal.SIGINT)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
    return {}


async def _refill_on_preempt(front, rates: Dict[str, float]) -> None:
    """Turn each tenant's refill on (``rates``: J/s) once its first
    preemption is recorded."""
    from repro_torch.server import admission as ADM

    left = dict(rates)
    while left:
        hit = {r.tenant for r in list(front.adm.records)
               if r.decision == ADM.PREEMPT_ENERGY} & set(left)
        for name in hit:
            pol = front.adm.tenant(name).policy
            front.adm.set_policy(name, dataclasses.replace(
                pol, refill_j_per_s=left.pop(name)))
        await asyncio.sleep(0.005)


async def _post(front, job) -> Dict[str, Any]:
    """Post the job's requests over HTTP (see :func:`front_door_job`)."""
    from repro_torch.obs import ListSink
    from repro_torch.server import HttpFrontDoor, generate, http_request

    prompts = job["prompts"]
    tenants = list(job.get("tenants", {})) or ["default"]
    seed0 = job.get("seed0", 0)
    events = ListSink()
    front.obs.tracer.add_sink(events)
    bodies = [dict(prompt=list(map(int, p)), max_new=job["max_new"],
                   seed=seed0 + i, tenant=tenants[i % len(tenants)])
              for i, p in enumerate(prompts)]
    stats = front.sch.stats
    idle = None
    refill = asyncio.create_task(
        _refill_on_preempt(front, job.get("refill_on_preempt", {})))
    try:
        async with HttpFrontDoor(front, host="127.0.0.1", port=0) as srv:
            got = []
            t0 = time.perf_counter()
            for w, n in enumerate(job.get("waves") or [len(prompts)]):
                if w:
                    steps, t_idle = stats.decode_steps, time.perf_counter()
                    await asyncio.sleep(job["idle_s"])
                    idle = {"seconds": time.perf_counter() - t_idle,
                            "steps": stats.decode_steps - steps}
                got += await asyncio.gather(*[
                    generate(srv.host, srv.port, b)
                    for b in bodies[len(got):len(got) + n]])
            makespan = time.perf_counter() - t0
            metrics = await http_request(srv.host, srv.port, "GET",
                                         "/metrics")
            status = await http_request(srv.host, srv.port, "GET", "/stats")
    finally:
        refill.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await refill
    return {"streams": [t for t, _, _ in got], "done": [d for _, d, _ in got],
            "errors": [e for _, _, e in got],
            "results": [dataclasses.asdict(r) for r in front.results],
            "records": [dataclasses.asdict(r) for r in front.adm.records],
            "events": events.events,
            "metrics": metrics.partition(b"\r\n\r\n")[2].decode(),
            "stats_http": json.loads(status.partition(b"\r\n\r\n")[2]),
            "makespan_s": makespan, "idle": idle,
            "preemptions": front.preemptions}


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
