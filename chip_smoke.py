#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. **device and build** -- the card (``nvidia-smi`` name and power limit)
   and the ``nvcc`` build of the three Hopper kernels from
   ``src/repro_torch/kernels/csrc`` (all sources compile in parallel).
2. **kernels** -- K1 ``aimc_spiking_linear``, K2 ``ssa_decode`` and K3
   ``fused_decode_layer`` against their plain PyTorch versions on the card,
   at the serving path's widths (``d=256``, ``H=KV=4``, ``hd=64``, ``T=4``,
   ``B=8`` slots, ``L=256``) and at padding (``hd=16``, ``L=24``, ``B=3``)
   and GQA edges.  Outputs must be exactly equal.  Each kernel and its
   plain version are timed with CUDA events (runs of 20 back-to-back calls,
   median of 9 runs after warm-up).
3. **serve** -- the full-width ``xpikeformer-gpt-4-256`` (random weights
   from a seed) served by ``BatchScheduler(slots=8, cache_len=256)``: 16
   requests, prompts of 8-32 tokens, 32 new tokens each, submitted in
   waves so that admissions land mid-flight.  The launch counters must
   show K3 once per layer and decode step and K1/K2 on every prefill
   position; the same requests served through the plain versions on the
   card (``IntegerBackend``) must give the same token streams, and the
   reduced config on the card the tokens of the CPU.

Then the ``kernels`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the run
exits non-zero and prints no result.  Without a CUDA device it exits 2.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
ARCH = "xpikeformer-gpt-4-256"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor rate
REPS, BATCH, WARMUP = 9, 20, 5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def time_ms(fn) -> float:
    """Time of one call: CUDA events around ``BATCH`` back-to-back calls,
    over ``BATCH``; the median of ``REPS`` such runs after warm-up.  A call
    that the host cannot issue as fast as the card runs it is timed at the
    host's rate, which is what a caller of the wrapper gets."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(BATCH):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / BATCH)
    return statistics.median(times)


def nbytes(*xs) -> int:
    """Bytes of every tensor in ``xs`` (nested tuples/lists, None skipped)."""
    total = 0
    for x in xs:
        if isinstance(x, (tuple, list)):
            total += nbytes(*x)
        elif x is not None:
            total += x.numel() * x.element_size()
    return total


def bound(n_bytes: int, n_ops: int):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / INT8_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def max_abs_err(got, want) -> float:
    if isinstance(got, (tuple, list)):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    return float((got.double() - want.double()).abs().max())


# ---------------------------------------------------------------------------
# Inputs (torch.Generator: no JAX stream is mirrored here)
# ---------------------------------------------------------------------------


def triple(gen, d_in, d_out, dev, bias=True):
    """int8 levels in [-15, 15] with dyadic scales and biases, which put
    many membranes exactly on the threshold."""
    lv = torch.randint(-15, 16, (d_in, d_out), generator=gen, dtype=torch.int8)
    sc = torch.randint(1, 4, (d_out,), generator=gen).float() / 8
    bi = torch.randint(-4, 9, (d_out,), generator=gen).float() / 8
    return (lv.to(dev), sc.to(dev), bi.to(dev) if bias else None)


def spikes(gen, shape, p, dev):
    return (torch.rand(shape, generator=gen) < p).to(torch.uint8).to(dev)


def layer_inputs(gen, dev, *, t, b, d, h, kv, hd, l, dff, pos):
    s = torch.randint(0, 3, (t, b, d), generator=gen).float()
    sk = spikes(gen, (b, t, l, kv, hd), 0.3, "cpu")
    sv = spikes(gen, (b, t, l, kv, hd), 0.3, "cpu")
    for i, p in enumerate(pos):  # the serving invariant: rows >= pos are 0
        sk[i, :, p:] = 0
        sv[i, :, p:] = 0
    ws = [triple(gen, d, h * hd, dev), triple(gen, d, kv * hd, dev, bias=False),
          triple(gen, d, kv * hd, dev), triple(gen, h * hd, d, dev),
          triple(gen, d, dff, dev), triple(gen, dff, d, dev, bias=False)]
    rs = torch.randint(0, hd, (b, t, h, l), generator=gen, dtype=torch.int32)
    ra = torch.randint(0, l, (b, t, h, hd), generator=gen, dtype=torch.int32)
    head = [x.to(dev) for x in (s, sk, sv, torch.tensor(pos, dtype=torch.int32))]
    return head, ws, [rs.to(dev), ra.to(dev)]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(dev):
    from repro_torch.kernels import aimc_matmul as KA
    from repro_torch.kernels import decode_fused as KFD
    from repro_torch.kernels import ref as KREF
    from repro_torch.kernels import ssa_attention as KS

    gen = torch.Generator().manual_seed(1234)
    results = {}

    # K1 at the prefill shapes (one token: M=1) and a ragged edge
    k1 = {}
    for t, m, d_in, d_out in [(4, 1, 256, 256), (4, 1, 256, 1024),
                              (4, 1, 1024, 256), (3, 5, 64, 48)]:
        x = torch.randint(0, 4, (t, m, d_in), generator=gen).float().to(dev)
        w = triple(gen, d_in, d_out, dev, bias=d_out != 48)
        got = KA.aimc_spiking_linear_kernel(x, *w)
        want = KREF.aimc_spiking_linear_ref(x, *w)
        k1[(t, m, d_in, d_out)] = (got, want, x, w)
        check(torch.equal(got, want), f"K1 {t}x{m}x{d_in}->{d_out} differs")
    got, want, x, w = k1[(4, 1, 256, 256)]
    n_bytes = nbytes(x, w, got)
    results["aimc_spiking_linear"] = dict(
        shape="T=4, M=1, 256->256 (a prefill Q/K/V/O projection)",
        max_abs_err=max(max_abs_err(g, w_) for g, w_, *_ in k1.values()),
        ms=time_ms(lambda: KA.aimc_spiking_linear_kernel(x, *w)),
        plain_ms=time_ms(lambda: KREF.aimc_spiking_linear_ref(x, *w)),
        bound=bound(n_bytes, 2 * 4 * 1 * 256 * 256))

    # K2 at the prefill shape (G = 1 slot x T x H) and the padding edge
    k2 = {}
    for g, l, d in [(16, 256, 64), (48, 24, 16)]:
        q = spikes(gen, (g, 1, d), 0.5, dev)
        k = spikes(gen, (g, l, d), 0.5, dev)
        v = spikes(gen, (g, l, d), 0.5, dev)
        rs = torch.randint(0, d, (g, 1, l), generator=gen, dtype=torch.int32).to(dev)
        ra = torch.randint(0, l, (g, 1, d), generator=gen, dtype=torch.int32).to(dev)
        args = (q, k, v, rs, ra)
        got, want = KS.ssa_decode_kernel(*args), KREF.ssa_decode_ref(*args)
        k2[(g, l, d)] = (got, want, args)
        check(torch.equal(got, want), f"K2 G={g} L={l} D={d} differs")
    got, want, args = k2[(16, 256, 64)]
    results["ssa_decode"] = dict(
        shape="G=16 (1 slot x T=4 x H=4), L=256, D=64 (prefill)",
        max_abs_err=max(max_abs_err(g, w_) for g, w_, _ in k2.values()),
        ms=time_ms(lambda: KS.ssa_decode_kernel(*args)),
        plain_ms=time_ms(lambda: KREF.ssa_decode_ref(*args)),
        bound=bound(nbytes(args, got), 2 * 2 * 16 * 256 * 64))

    # K3 at the decode shape, the padding edge and GQA
    cases = {
        "main": dict(t=4, b=8, d=256, h=4, kv=4, hd=64, l=256, dff=1024,
                     pos=[0, 1, 40, 100, 200, 254, 255, 17]),
        "padding": dict(t=4, b=3, d=64, h=4, kv=4, hd=16, l=24, dff=128,
                        pos=[0, 9, 23]),
        "gqa": dict(t=4, b=8, d=256, h=4, kv=2, hd=64, l=256, dff=1024,
                    pos=[3, 0, 255, 256, 64, 128, 7, 31]),
    }
    k3 = {}
    for name, c in cases.items():
        head, ws, draws = layer_inputs(gen, dev, **c)
        run = (lambda head=head, ws=ws, draws=draws, hd=c["hd"]:
               KFD.fused_decode_layer_kernel(*head, *ws, *draws, hd=hd))
        plain = (lambda head=head, ws=ws, draws=draws, hd=c["hd"]:
                 KREF.decode_layer_ref(*head, *ws, *draws, hd=hd))
        got, want = run(), plain()
        k3[name] = (got, want, run, plain, head, ws, draws)
        check(all(torch.equal(g, w_) for g, w_ in zip(got, want)),
              f"K3 case {name} differs")
    got, want, run, plain, head, ws, draws = k3["main"]
    c = cases["main"]
    t, b, d, h, hd, l, dff = (c[k] for k in ("t", "b", "d", "h", "hd", "l", "dff"))
    macs = t * b * (d * h * hd * 3 + h * hd * d + 2 * d * dff) + 2 * b * t * h * l * hd
    results["fused_decode_layer"] = dict(
        shape="T=4, B=8, d=256, H=KV=4, hd=64, L=256, d_ff=1024 (decode)",
        max_abs_err=max(max_abs_err(g, w_) for g, w_, *_ in k3.values()),
        ms=time_ms(run), plain_ms=time_ms(plain),
        bound=bound(nbytes(head, ws, draws, got), 2 * macs))
    torch.cuda.synchronize()
    return results


# ---------------------------------------------------------------------------
# Phase 3: serve the full-width spiking GPT
# ---------------------------------------------------------------------------


def make_requests(vocab: int, n: int = 16):
    gen = torch.Generator().manual_seed(7)
    lens = torch.randint(8, 33, (n,), generator=gen).tolist()
    return [torch.randint(0, vocab, (k,), generator=gen).tolist() for k in lens]


def drive(sch, prompts, max_new: int, wave: int = 4, gap: int = 8):
    """Submit ``wave`` requests every ``gap`` steps (so later admissions
    land while earlier requests decode), then serve to the end."""
    rids = []
    t0 = time.perf_counter()
    for i in range(0, len(prompts), wave):
        rids += [sch.submit(p, max_new, seed=1000 + i + j)
                 for j, p in enumerate(prompts[i:i + wave])]
        for _ in range(gap):
            sch.step()
    out = sch.run()
    torch.cuda.synchronize()
    return [out[r] for r in rids], time.perf_counter() - t0


def profile_window(fn) -> dict:
    """One call of ``fn`` under torch.profiler: wall time, the card's busy
    time (sum of kernel times; one stream, so they do not overlap), the
    idle share, the kernel count and the four costliest kernels.  The
    profiler's own host cost lengthens the wall time, so the idle share is
    an upper bound; ``None`` where the trace shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
                kernels=sum(e.count for e in kern),
                top=[[e.key[:70], e.count, e.self_device_time_total / 1e3]
                     for e in top])


def phase_serve(dev):
    from repro_torch.engine import XpikeformerEngine, get_backend
    from repro_torch.kernels import build as KB
    from repro_torch.models import transformer as T

    eng = XpikeformerEngine.from_config(ARCH, task="lm", backend="cuda",
                                        device=dev)
    cfg = eng.cfg
    eng.init(seed=0)
    prompts = make_requests(cfg.vocab_size)
    max_new = 32
    sch = eng.scheduler(slots=8, cache_len=256)
    check(sch.plan.fused, f"decode plan is not fused: {sch.plan.describe()}")
    drive(sch, prompts[:2], 4)  # warm-up: first cuBLAS/allocator calls
    sch.reset()

    KB.reset_launches()
    outs, wall_s = drive(sch, prompts, max_new)
    launches = dict(KB.LAUNCHES)
    st = sch.stats
    layers = cfg.num_layers
    check(st.admissions == len(prompts) and st.evictions == len(prompts),
          "not every request was admitted and evicted")
    check(all(len(o) == max_new for o in outs), "a request got too few tokens")
    check(all(0 <= tok < cfg.vocab_size for o in outs for tok in o),
          "a token is out of the vocabulary")
    check(launches["fused_decode_layer"] == layers * st.decode_steps,
          f"K3 launches {launches['fused_decode_layer']} != "
          f"{layers} layers x {st.decode_steps} steps")
    check(launches["ssa_decode"] == layers * st.prefill_tokens > 0,
          f"K2 launches {launches['ssa_decode']} != {layers} x "
          f"{st.prefill_tokens} prefill positions")
    check(launches["aimc_spiking_linear"] == 6 * layers * st.prefill_tokens,
          f"K1 launches {launches['aimc_spiking_linear']} != 6 x {layers} x "
          f"{st.prefill_tokens}")
    served = dict(
        tokens=st.decoded_tokens, decode_steps=st.decode_steps,
        prefill_tokens=st.prefill_tokens, admissions=st.admissions,
        peak_active_slots=st.peak_active_slots, wall_s=wall_s,
        decode_s=st.decode_s, prefill_s=st.prefill_s,
        tokens_per_s=st.decoded_tokens / wall_s,
        decode_tokens_per_s=st.decode_tokens_per_sec,
        decode_step_ms=1e3 * st.decode_s / st.decode_steps,
        prefill_token_ms=1e3 * st.prefill_s / st.prefill_tokens)

    # where a step's time goes: one admission (15 prefill positions), then
    # three decode steps of 8 busy slots
    sch.reset()
    sch.submit(list(range(16)), 4, seed=1)
    served["profile_prefill_15_positions"] = profile_window(sch.admit)
    for i, p in enumerate(prompts[1:8]):
        sch.submit(p, 8, seed=2 + i)
    sch.admit()
    served["profile_decode_3_steps"] = profile_window(
        lambda: [sch.step() for _ in range(3)])

    # the same requests through the plain versions on the card
    plain = XpikeformerEngine(cfg=cfg, backend=get_backend("integer"),
                              device=eng.device, params=eng.params)
    psch = plain.scheduler(slots=8, cache_len=256)
    pouts, served["plain_wall_s"] = drive(psch, prompts, max_new)
    check(pouts == outs, "kernel and plain token streams differ")

    # one batched step's logits: finite, of the expected shape
    cache = T.init_cache(cfg, 8, 256, dev)
    toks = torch.arange(8, device=dev).view(8, 1)
    logits, _ = T.decode_step(sch.params, cache, toks, cfg, backend=eng.backend,
                              seeds=torch.arange(8, device=dev), plan=sch.plan)
    check(tuple(logits.shape) == (8, 1, cfg.vocab_size), "logits shape")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")

    # the reduced config: card (kernels) == CPU (plain versions)
    small = {}
    for d, backend in (("cpu", "integer"), (dev, "cuda")):
        e = XpikeformerEngine.from_config(ARCH, reduced=True, backend=backend,
                                          device=d)
        e.init(seed=3)
        small[str(d)], _ = e.serve(prompts[:3], 8, slots=2, cache_len=64)
    check(small["cpu"] == small[str(dev)], "reduced config: card != CPU")
    served["reduced_config_matches_cpu"] = True
    return launches, served, outs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as KB

    torch.backends.cuda.matmul.allow_tf32 = False  # the unembed stays f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    build_s = KB.build()
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "Used" in ln]
             for n, log in KB.BUILD_LOG.items()}
    emit({"phase": "build", "card": card, "build_s": build_s,
          "sources": list(KB.SOURCES), "ptxas": ptxas})

    t0 = time.perf_counter()
    kres = phase_kernels(dev)
    emit({"phase": "kernels", "card": card, "exact": True,
          "seconds": time.perf_counter() - t0,
          **{k: {kk: vv for kk, vv in v.items() if kk != "bound"}
             for k, v in kres.items()}})

    t0 = time.perf_counter()
    launches, served, outs = phase_serve(dev)
    emit({"phase": "serve", "card": card, "arch": ARCH, "slots": 8,
          "cache_len": 256, "requests": len(outs),
          "seconds": time.perf_counter() - t0, **served,
          "launches": launches, "first_tokens": outs[0][:8]})

    meta = {
        "aimc_spiking_linear": ("src/repro_torch/kernels/csrc/aimc_matmul.cu",
                                "src/repro/kernels/aimc_matmul.py:205"),
        "ssa_decode": ("src/repro_torch/kernels/csrc/ssa_attention.cu",
                       "src/repro/kernels/ssa_attention.py:120"),
        "fused_decode_layer": ("src/repro_torch/kernels/csrc/decode_fused.cu",
                               "src/repro/kernels/decode_fused.py:283"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = kres[name]
        bound_ms, bound_by = r["bound"]
        check(launches[name] > 0, f"{name} never ran on the main path")
        check(r["max_abs_err"] == 0.0, f"{name} differs from its plain version")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "exact": r["max_abs_err"] == 0.0,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "shape": r["shape"]})
    check(all(math.isfinite(k["ms"]) for k in kernels), "a time is not finite")
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
