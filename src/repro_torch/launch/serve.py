"""Serving CLI of the port: continuous batching of an LM-stack arch.

    python -m repro_torch.launch.serve --arch xpikeformer-gpt-4-256 --full \
        --requests 8
    python -m repro_torch.launch.serve --arch yi-9b --requests 4 --device cpu
    python -m repro_torch.launch.serve --arch xpikeformer-gpt-4-256 --full \
        --paged --page-len 8 [--pages N]
    python -m repro_torch.launch.serve --arch xpikeformer-gpt-4-256 --full \
        --program --drift-step 60 --recal-every 3600   # PCM lifecycle + energy
    python -m repro_torch.launch.serve --arch xpikeformer-gpt-4-256 --full \
        --mesh 2x2
    python -m repro_torch.launch.serve --arch xpikeformer-gpt-4-256 --full \
        --http --trace-out events.jsonl          # HTTP/SSE front door
    python -m repro_torch.launch.serve --arch xpikeformer-gpt-4-256 --full \
        --mesh 2x2 --http                        # ... over a mesh

It takes the reference CLI's spellings (``src/repro/launch/serve.py``):
without ``--full`` it serves the reduced config (``--smoke`` says so
explicitly); ``--pages N`` sizes the page pool (0, the default: ``slots *
cache_len / page_len`` + 2 reserved pages; ``--n-pages`` is an alias);
``--backend pallas`` is the kernel backend (an alias of ``cuda``), and
``--backend reference`` the float backend (plain PyTorch ops, float
weights; it has no fused layer, so it decodes unfused).

Serves ``--requests`` synthetic prompts (the reference CLI's prompts:
``randint(fold_in(PRNGKey(seed + 1), i), (4 + 3 * (i % 4),), 0, vocab)``)
with random weights from ``--seed``, on the CUDA kernels by default.
``--paged`` serves off the block-paged pool (prefix sharing, chunked
prefill; the same tokens as dense).  ``--program`` programs the spiking
linears onto simulated PCM (:mod:`repro_torch.aimc_device`, key
``PRNGKey(seed + 42)`` as in the reference CLI) before serving;
``--drift-step`` and ``--recal-every`` set the device seconds per decode
step and the GDC recalibration interval of the drift lifecycle (0: wall
clock / never).  ``--mesh DxM`` serves on a ``(data, model)`` mesh: it
spawns the D*M ranks (:func:`repro_torch.launch.mesh.run_ranks`), or, run
under ``torchrun --nproc-per-node D*M``, joins the ranks torchrun started;
slots split over ``data`` (``--slots`` a multiple of D), a spiking
stack's heads and crossbars over ``model`` (a part they do not divide is
held whole), a MoE stack's experts over ``model``; a spiking stack's
tokens are one device's.  Every run prints the metered energy.
``--device cpu`` runs the plain PyTorch versions.

Every name of the registry serves, on one device or a mesh: a float arch
(dense, local:global, SSD, RG-LRU, MoE, or a frontend backbone, which
decodes its tokens through the embedding: "serving over stub
embeddings") decodes on the float path, where ``--backend`` has no part
and ``--program``, ``--paged`` and ``--decode-kernel fused`` raise.  A MoE
name routes its experts with the scheduler's default
``moe_impl="ep_a2a"`` (the sort-based dispatch, as the reference CLI
does); on a mesh the dispatch all-to-alls over the model group.

One device's scheduler always carries a telemetry bundle
(:class:`repro_torch.obs.Telemetry`: metrics, lifecycle tracer, flight
recorder).  ``--trace-out events.jsonl`` appends the lifecycle events
(one JSON object a line; ``repro_torch.obs.perfetto_export`` converts them
for ui.perfetto.dev); ``--profile-steps N`` captures N decode steps with
``torch.profiler`` into a Chrome trace under ``--profile-dir``.
``--http`` serves ``POST /generate`` (SSE token stream), ``GET /stats``,
``GET /metrics`` (Prometheus text) and ``GET /healthz`` on ``--host``:
``--port`` through :mod:`repro_torch.server` instead of the synthetic
requests, until Ctrl-C.

On a mesh (a process a rank) rank 0 alone holds the telemetry: the trace
sink and the profiler window are its scheduler's.  With ``--http`` rank 0
takes the requests and every other rank steps with it
(:mod:`repro_torch.server.mesh`: before each step rank 0 broadcasts what
its scheduler was told since the last one).  Ctrl-C, which a terminal
sends to every rank, stops rank 0's front door and through it the other
ranks (which ignore it), and rank 0's summary is printed; a rank that
fails fails the front door's open streams and the run.
"""

from __future__ import annotations

import argparse
import math
import os
import signal
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import aimc_device as AD
from repro_torch import prng
from repro_torch.engine import XpikeformerEngine
from repro_torch.models import transformer as T
from repro_torch.obs import JsonlSink, StepProfiler, Telemetry

DEFAULT_PROFILE_DIR = os.path.join(tempfile.gettempdir(), "xpike-profile")


def make_prompts(n: int, vocab: int, seed: int) -> List[List[int]]:
    key = prng.PRNGKey(seed + 1)
    return [prng.randint(prng.fold_in(key, i), (4 + 3 * (i % 4),), 0,
                         vocab).tolist() for i in range(n)]


# the reference CLI's backend names: its Pallas kernels are the CUDA kernels
BACKEND_ALIASES = {"pallas": "cuda"}


def _backend(name: str) -> str:
    return BACKEND_ALIASES.get(name, name)


def serve(arch: str, *, smoke: bool = False, n_requests: int = 8,
          slots: int = 4, max_new: int = 16, cache_len: int = 64,
          seed: int = 0, backend: str = "cuda", decode_kernel: str = "auto",
          paged: bool = False, page_len: int = 8,
          n_pages: Optional[int] = None, device: str = "cuda",
          program: bool = False, drift_step_s: float = 0.0,
          recal_every_s: float = 0.0, mesh: Optional[str] = None,
          http: bool = False, host: str = "127.0.0.1", port: int = 8000,
          trace_out: str = "", profile_steps: int = 0,
          profile_dir: str = DEFAULT_PROFILE_DIR):
    backend = _backend(backend)
    if mesh:
        return serve_mesh(
            arch, mesh, smoke=smoke, n_requests=n_requests, slots=slots,
            max_new=max_new, cache_len=cache_len, seed=seed, backend=backend,
            decode_kernel=decode_kernel, paged=paged, page_len=page_len,
            device=device, program=program, drift_step_s=drift_step_s,
            recal_every_s=recal_every_s, http=http, host=host, port=port,
            trace_out=trace_out, profile_steps=profile_steps,
            profile_dir=profile_dir)
    eng = XpikeformerEngine.from_config(arch, task="lm", backend=backend,
                                        reduced=smoke, device=device)
    cfg = eng.cfg
    if program and not T.spiking_decode_enabled(cfg):
        raise SystemExit(f"--program needs a spiking SSA arch, not {arch}")
    if cfg.frontend != "none":
        print(f"[serve] {arch} is a {cfg.family} backbone; serving over stub "
              "embeddings")
    eng.init(seed)
    drift = None
    if program:
        eng.program(prng.PRNGKey(seed + 42))
        drift = AD.DriftPolicy(seconds_per_step=drift_step_s,
                               recal_interval_s=recal_every_s)
        print(f"[serve] programmed spiking linears onto PCM "
              f"(drift {drift_step_s or 'wall-clock'} s/step, "
              f"GDC every {recal_every_s or 'never'} s)")
    sch = eng.scheduler(slots=slots, cache_len=cache_len,
                        decode_kernel=decode_kernel, paged=paged,
                        page_len=page_len, n_pages=n_pages, drift=drift)
    if sch.plan is not None:
        print(f"[serve] {cfg.name} on {eng.device} through the "
              f"'{eng.backend.name}' backend; decode kernel: "
              f"{sch.plan.describe()}")
    else:
        print(f"[serve] {cfg.name} on {eng.device}: the float decode path "
              f"({cfg.dtype})")
    # telemetry: metrics + tracer + flight recorder, plus the opt-in JSONL
    # sink and torch.profiler window; host-side only
    profiler = None
    if profile_steps > 0:
        profiler = StepProfiler(profile_steps, profile_dir)
        print(f"[serve] profiling {profile_steps} decode steps -> "
              f"{profile_dir} (torch.profiler)")
    obs = Telemetry.create(profiler=profiler)
    if trace_out:
        obs.tracer.add_sink(JsonlSink(trace_out))
        print(f"[serve] tracing request lifecycle -> {trace_out} (JSONL)")
    sch.attach_obs(obs)
    if http:
        _serve_http(sch, host=host, port=port)
        return []
    prompts = make_prompts(n_requests, eng.cfg.vocab_size, seed)
    rids = [sch.submit(p, max_new, seed=seed + i) for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    outs = sch.run()
    dt = time.perf_counter() - t0
    st = sch.stats
    print(f"[serve] served {st.requests} requests, {st.decoded_tokens} tokens "
          f"in {dt:.2f}s ({st.tokens_per_sec:.1f} tok/s, "
          f"{st.decode_steps} batched decode steps, {st.admissions} admissions)")
    if paged:
        print(f"[serve] paged: {sch.n_pages} pages of {page_len} tokens, "
              f"{st.prefix_hits} prefix-cache hits ({st.prefix_hit_tokens} "
              f"prompt tokens skipped), {st.cow_copies} copy-on-write pages, "
              f"peak {st.pages_in_use_peak} pages in use")
    if st.energy_j > 0:
        print(f"[serve] energy: {st.energy_j*1e6:.2f} uJ total "
              f"({st.j_per_token*1e9:.1f} nJ/token, "
              f"{st.spike_events:.0f} spike events)")
        worst = max(sch.request_energy_j.items(), key=lambda kv: kv[1])
        print(f"[serve] per-request energy: max rid={worst[0]} "
              f"{worst[1]*1e9:.1f} nJ")
    if program:
        print(f"[serve] device clock t={st.t_device_s:.1f}s, "
              f"{st.recalibrations} GDC recalibrations")
    return [outs[r] for r in rids]


def _print_summary(st) -> None:
    """The HTTP serve's summary of its :class:`ServeStats`."""
    print(f"\n[serve] served {st.requests} requests, {st.decoded_tokens} "
          f"tokens ({st.tokens_per_sec:.1f} tok/s, {st.decode_steps} batched "
          f"decode steps, {st.admissions} admissions)")
    if st.energy_j > 0:
        print(f"[serve] energy: {st.energy_j*1e6:.2f} uJ total "
              f"({st.j_per_token*1e9:.1f} nJ/token, "
              f"{st.spike_events:.0f} spike events)")


def _serve_http(sch, *, host: str, port: int) -> None:
    """Run the async HTTP/SSE front door over a built scheduler until
    interrupted, then print the serve summary."""
    import asyncio

    from repro_torch.server import FrontDoor, HttpFrontDoor

    async def _run():
        srv = HttpFrontDoor(FrontDoor(sch), host=host, port=port)
        await srv.start()
        print(f"[serve] HTTP front door on http://{srv.host}:{srv.port} "
              "(POST /generate, GET /stats, GET /metrics, GET /healthz); "
              "Ctrl-C to stop", flush=True)
        try:
            await srv._server.serve_forever()
        except asyncio.CancelledError:
            pass
        finally:
            await srv.stop()

    t0 = time.perf_counter()
    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        pass
    st = sch.stats
    st.wall_s += time.perf_counter() - t0
    _print_summary(st)


def serve_mesh(arch: str, spec: str, *, smoke: bool, n_requests: int,
               slots: int, max_new: int, cache_len: int, seed: int,
               backend: str, decode_kernel: str, paged: bool, page_len: int,
               device: str, program: bool, drift_step_s: float,
               recal_every_s: float, http: bool = False,
               host: str = "127.0.0.1", port: int = 8000,
               trace_out: str = "", profile_steps: int = 0,
               profile_dir: str = DEFAULT_PROFILE_DIR):
    """``serve`` on a ``(data, model)`` mesh: every rank builds the same
    random weights (and programs them with ``PRNGKey(seed + 42)``) and
    takes its share; then every rank serves the same requests, or, with
    ``http``, rank 0 serves HTTP through the front door until Ctrl-C and
    the other ranks follow it (:func:`repro_torch.distributed.jobs.
    front_door_job`).  Rank 0 alone attaches the telemetry
    (``trace_out``, ``profile_steps``) and reports."""
    from repro_torch.configs import registry
    from repro_torch.distributed import jobs
    from repro_torch.launch import mesh as M
    from repro_torch.serving import ServeStats

    shape = M.parse_mesh_spec(spec)
    cfg = (registry.reduced_config(arch) if smoke
           else registry.get_config(arch))
    if program and not T.spiking_decode_enabled(cfg):
        raise SystemExit(f"--program needs a spiking SSA arch, not {arch}")
    drift = (AD.DriftPolicy(seconds_per_step=drift_step_s,
                            recal_interval_s=recal_every_s)
             if program else None)
    job = dict(cfg=cfg, init_seed=seed,
               program_seed=seed + 42 if program else None, backend=backend,
               prompts=make_prompts(n_requests, cfg.vocab_size, seed),
               max_new=max_new, slots=slots, cache_len=cache_len, seed0=seed,
               paged=paged, page_len=page_len, drift=drift,
               decode_kernel=decode_kernel, trace_out=trace_out,
               profile_steps=profile_steps, profile_dir=profile_dir)
    if http:
        job.update(kind="front_door", http=(host, port))
    if trace_out:
        print(f"[serve] rank 0 traces the request lifecycle -> {trace_out} "
              "(JSONL)")
    if profile_steps > 0:
        print(f"[serve] rank 0 profiles {profile_steps} decode steps -> "
              f"{profile_dir} (torch.profiler)")
    world = shape[0] * shape[1]
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun
        if int(os.environ["WORLD_SIZE"]) != world:
            raise SystemExit(f"--mesh {spec} needs {world} ranks, torchrun "
                             f"started {os.environ['WORLD_SIZE']}")
        mesh = M.init_mesh(shape, int(os.environ["RANK"]),
                           init_method="env://", device=device)
        res = jobs.run_jobs(mesh, [job])[0]
        if mesh.rank != 0:
            return [] if http else res["outputs"]
        layout = f"{mesh.backend} on {mesh.device}"
    else:
        # the spawned ranks inherit the ignored SIGINT; rank 0's front door
        # takes it back, and this process waits for the ranks to end
        sigint = signal.signal(signal.SIGINT, signal.SIG_IGN) if http else None
        try:
            res = M.run_ranks(jobs.run_jobs, shape, device=device,
                              args=([job],),
                              wait_s=math.inf if http else None)[0][0]
        finally:
            if sigint is not None:
                signal.signal(signal.SIGINT, sigint)
        layout = (f"{M.pick_backend(world, device)}, {world} spawned ranks "
                  f"on {device}")
    if http:
        st = ServeStats(**res["stats"])
        st.wall_s = res["wall_s"]
        print(f"[serve] {cfg.name} on a (data={shape[0]}, model={shape[1]}) "
              f"mesh ({layout}); rank 0 served HTTP")
        _print_summary(st)
        return []
    st = res["stats"]
    path = (f"through '{res['backend']}'; decode kernel "
            f"{'fused' if res['fused'] else 'unfused'}"
            if T.spiking_decode_enabled(cfg) else "on the float decode path")
    print(f"[serve] {cfg.name} on a (data={shape[0]}, model={shape[1]}) mesh "
          f"({layout}) {path}")
    print(f"[serve] served {st['requests']} requests, {st['decoded_tokens']} "
          f"tokens in {res['wall_s']:.2f}s "
          f"({st['decoded_tokens'] / res['wall_s']:.1f} tok/s, "
          f"{st['decode_steps']} batched decode steps, {st['admissions']} "
          f"admissions)")
    if paged:
        print(f"[serve] paged: {st['prefix_hits']} prefix-cache hits, "
              f"{st['cow_copies']} copy-on-write pages")
    print(f"[serve] energy: {st['energy_j']*1e6:.2f} uJ total; rank 0's "
          f"kernel launches: "
          f"{ {k: v for k, v in res['launches'].items() if v} }")
    if program:
        print(f"[serve] device clock t={st['t_device_s']:.1f}s, "
              f"{st['recalibrations']} GDC recalibrations")
    return res["outputs"]


def parse_args(argv=None) -> Dict[str, Any]:
    """The command line as :func:`serve`'s arguments (``arch`` first)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="cuda",
                    choices=["cuda", "integer", "pallas", "reference"],
                    help="cuda (alias pallas): the kernels; integer: their "
                         "plain versions; reference: the float backend")
    ap.add_argument("--decode-kernel", default="auto",
                    choices=["auto", "fused", "unfused"])
    ap.add_argument("--paged", action="store_true",
                    help="serve off the block-paged spike-train KV pool")
    ap.add_argument("--page-len", type=int, default=8)
    ap.add_argument("--pages", "--n-pages", dest="pages", type=int,
                    default=0,
                    help="page-pool size (0: slots * cache_len / page_len "
                         "+ 2 reserved pages)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="serve the full config (default: the reduced one)")
    ap.add_argument("--smoke", dest="smoke", action="store_true",
                    help="serve the reduced config (the default)")
    ap.set_defaults(smoke=True)
    ap.add_argument("--program", action="store_true",
                    help="program spiking linears onto simulated PCM first")
    ap.add_argument("--drift-step", type=float, default=0.0,
                    help="device seconds per decode step (0 = wall clock)")
    ap.add_argument("--recal-every", type=float, default=0.0,
                    help="GDC recalibration interval in device seconds "
                         "(0 = never)")
    ap.add_argument("--mesh", default=None,
                    help="serve on a (data, model) mesh, e.g. 2x2")
    ap.add_argument("--http", action="store_true",
                    help="serve over HTTP/SSE (POST /generate streams "
                         "tokens) instead of running synthetic requests")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--trace-out", default="",
                    help="append request-lifecycle trace events to this "
                         "JSONL file")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="capture this many decode steps with "
                         "torch.profiler (0 = off)")
    ap.add_argument("--profile-dir", default=DEFAULT_PROFILE_DIR,
                    help="where --profile-steps writes its Chrome trace")
    a = ap.parse_args(argv)
    return dict(arch=a.arch, smoke=a.smoke, n_requests=a.requests,
                slots=a.slots, max_new=a.max_new, cache_len=a.cache_len,
                seed=a.seed, backend=_backend(a.backend),
                decode_kernel=a.decode_kernel, paged=a.paged,
                page_len=a.page_len, n_pages=a.pages or None,
                device=a.device, program=a.program,
                drift_step_s=a.drift_step, recal_every_s=a.recal_every,
                mesh=a.mesh, http=a.http, host=a.host, port=a.port,
                trace_out=a.trace_out, profile_steps=a.profile_steps,
                profile_dir=a.profile_dir)


def main(argv=None):
    kw = parse_args(argv)
    with torch.no_grad():
        serve(kw.pop("arch"), **kw)


if __name__ == "__main__":
    main()
