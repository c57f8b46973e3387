"""Past the port's old caps: any T, head width, sequence length and width.

The plain versions of K1/K5 (T = 9 and 16, residual-valued spikes up to
17), K3/K9 (T = 9, hd = 544), K8 (N = 513) and K2 (hd = 544) are held
exactly against the JAX oracles of ``repro.kernels.ref`` on inputs made
with numpy.  The launch plans the CUDA wrappers compute from a shape (the
K1/K5 regime and split, K8's design, K3/K9's shared memory) are checked
here too, at every shape ``chip_smoke.py`` gives the kernels and past
them, and the serve CLI's reference spellings against the port's own.
``tests/test_torch_gpu.py`` holds the CUDA kernels against these plain
versions at the same shapes on the card.
"""

import ctypes
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro_torch.kernels import aimc_matmul as KA
from repro_torch.kernels import decode_fused as KFD
from repro_torch.kernels import ssa_attention as KS
from repro_torch.launch import serve as serve_cli

ARCH = "xpikeformer-gpt-4-256"


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _eq(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want.astype(got.dtype)), (
        f"{np.sum(got != want)} of {got.size} elements differ")


def _triple(rng, d_in, d_out, bias=True):
    """Dyadic scales and biases put many membranes on the threshold."""
    lv = rng.integers(-15, 16, (d_in, d_out)).astype(np.int8)
    sc = (rng.integers(1, 4, d_out) / 8.0).astype(np.float32)
    bi = (rng.integers(-4, 9, d_out) / 8.0).astype(np.float32)
    return lv, sc, (bi if bias else None)


def _jw(w):
    return None if w is None else tuple(None if x is None else jnp.asarray(x)
                                        for x in w)


def _tw(w):
    return None if w is None else tuple(None if x is None else _t(x) for x in w)


# ---------------------------------------------------------------------------
# K1 and K5 at any T
# ---------------------------------------------------------------------------

CROSSBAR_CASES = [(9, 3, 40, 24), (16, 2, 64, 33), (9, 8, 130, 48)]


@pytest.mark.parametrize("t,m,d_in,d_out", CROSSBAR_CASES)
def test_spiking_linear_plain_long_trains(t, m, d_in, d_out):
    """Residual-valued spikes in [0, 17] (1 + 2 x depth 8), dyadic scales:
    the plain K1 equals JAX's oracle past the old 8-step cap."""
    rng = np.random.default_rng(t * d_in + d_out)
    x = rng.integers(0, 18, (t, m, d_in)).astype(np.float32)
    lv, sc, bi = _triple(rng, d_in, d_out)
    sc = sc / 16  # residual counts are large: keep membranes near threshold
    want = JREF.aimc_spiking_linear_ref(jnp.asarray(x), jnp.asarray(lv),
                                        jnp.asarray(sc), jnp.asarray(bi))
    got = KA.aimc_spiking_linear_kernel(_t(x), _t(lv), _t(sc), _t(bi))
    _eq(got, want)
    assert 0 < int(got.sum()) < got.numel()


@pytest.mark.parametrize("t,m,d_in,d_out", CROSSBAR_CASES)
def test_counts_plain_long_trains(t, m, d_in, d_out):
    rng = np.random.default_rng(7 * t + d_in)
    x = rng.integers(0, 18, (t, m, d_in)).astype(np.float32)
    lv = rng.integers(-127, 128, (d_in, d_out)).astype(np.int8)
    want = JREF.aimc_counts_ref(jnp.asarray(x), jnp.asarray(lv))
    _eq(KA.aimc_matmul_counts_kernel(_t(x), _t(lv)), want)


# ---------------------------------------------------------------------------
# K3 and K9 at T = 9 and hd = 544
# ---------------------------------------------------------------------------

# name: (t, b, d, h, kv, hd, l, dff, pos)
LAYER_CAPS = {
    "t9": (9, 2, 48, 2, 1, 16, 24, 64, [5, 23]),
    "hd544": (2, 2, 64, 2, 1, 544, 16, 64, [3, 15]),
}


def _layer_weights(rng, d, h, kv, hd, dff):
    return [_triple(rng, d, h * hd), _triple(rng, d, kv * hd, bias=False),
            _triple(rng, d, kv * hd), _triple(rng, h * hd, d),
            _triple(rng, d, dff), _triple(rng, dff, d, bias=False)]


@pytest.mark.parametrize("case", sorted(LAYER_CAPS))
def test_decode_layer_plain_past_caps(case):
    t, b, d, h, kv, hd, l, dff, pos = LAYER_CAPS[case]
    rng = np.random.default_rng(len(case) + t)
    s = rng.integers(0, 3, (t, b, d)).astype(np.float32)
    sk = (rng.random((b, t, l, kv, hd)) < 0.5).astype(np.uint8)
    sv = (rng.random((b, t, l, kv, hd)) < 0.5).astype(np.uint8)
    for i, p in enumerate(pos):
        sk[i, :, p:] = 0
        sv[i, :, p:] = 0
    ws = _layer_weights(rng, d, h, kv, hd, dff)
    rs = rng.integers(0, hd, (b, t, h, l)).astype(np.int32)
    ra = rng.integers(0, l, (b, t, h, hd)).astype(np.int32)
    pos = np.asarray(pos, np.int32)
    want = jax.jit(JREF.decode_layer_ref, static_argnames=("hd",))(
        jnp.asarray(s), jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(pos),
        *(_jw(w) for w in ws), jnp.asarray(rs), jnp.asarray(ra), hd=hd)
    got = KFD.fused_decode_layer_kernel(
        _t(s), _t(sk), _t(sv), _t(pos), *(_tw(w) for w in ws), _t(rs),
        _t(ra), hd=hd)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("case", sorted(LAYER_CAPS))
def test_decode_layer_paged_plain_past_caps(case):
    t, b, d, h, kv, hd, _, dff, pos = LAYER_CAPS[case]
    pl, mp = 8, 3
    rng = np.random.default_rng(50 + len(case) + t)
    # slot i owns fresh pages for its blocks 0 .. pos // pl; page 0 is the
    # null page, page 1 the trash page; rows at and past pos are zero
    table = np.zeros((b, mp), np.int32)
    nxt = 2
    for i, p in enumerate(pos):
        for j in range(p // pl + 1):
            table[i, j] = nxt
            nxt += 1
    write = np.array([table[i, p // pl] for i, p in enumerate(pos)], np.int32)
    kp = (rng.random((nxt, t, kv, pl, hd)) < 0.5).astype(np.uint8)
    vp = (rng.random((nxt, t, kv, pl, hd)) < 0.5).astype(np.uint8)
    kp[0] = vp[0] = 0
    for i, p in enumerate(pos):
        for j, pid in enumerate(table[i]):
            if pid >= 2:
                kp[pid, :, :, min(max(p - j * pl, 0), pl):] = 0
                vp[pid, :, :, min(max(p - j * pl, 0), pl):] = 0
    s = rng.integers(0, 3, (t, b, d)).astype(np.float32)
    ws = _layer_weights(rng, d, h, kv, hd, dff)
    rs = rng.integers(0, hd, (b, t, h, mp * pl)).astype(np.int32)
    ra = rng.integers(0, mp * pl, (b, t, h, hd)).astype(np.int32)
    pos = np.asarray(pos, np.int32)
    want = jax.jit(JREF.decode_layer_paged_ref, static_argnames=("hd",))(
        *(jnp.asarray(a) for a in (s, kp, vp, table, pos, write)),
        *(_jw(w) for w in ws), jnp.asarray(rs), jnp.asarray(ra), hd=hd)
    got = KFD.fused_decode_layer_paged_kernel(
        *(_t(a) for a in (s, kp, vp, table, pos, write)),
        *(_tw(w) for w in ws), _t(rs), _t(ra), hd=hd)
    for g, w in zip(got, want):
        _eq(g, w)


def test_layer_shared_memory_budget():
    """The serving layer's shared memory, T = 9 and hd = 544 fit the
    card's per-block budget; a train too long for it is refused, naming T
    and the bytes (before any CUDA operand check)."""
    assert KFD.layer_smem_bytes(4, 256, 4, 4, 64, 256, 1024) == 27760
    for t, b, d, h, kv, hd, l, dff, _ in LAYER_CAPS.values():
        assert KFD.layer_smem_bytes(t, d, h, kv, hd, l, dff) <= KFD.SMEM_BUDGET
    t = 80
    s = torch.zeros((t, 1, 256))
    ws = [(torch.zeros((256, 256), dtype=torch.int8), torch.ones(256), None)
          for _ in range(3)]
    ws += [(torch.zeros((256, 256), dtype=torch.int8), torch.ones(256), None),
           (torch.zeros((256, 1024), dtype=torch.int8), torch.ones(1024), None),
           (torch.zeros((1024, 256), dtype=torch.int8), torch.ones(256), None)]
    rs = torch.zeros((1, t, 4, 256), dtype=torch.int32)
    ra = torch.zeros((1, t, 4, 64), dtype=torch.int32)
    need = KFD.layer_smem_bytes(t, 256, 4, 4, 64, 256, 1024)
    assert need > KFD.SMEM_BUDGET
    with pytest.raises(ValueError, match=f"T={t} .* needs {need} bytes"):
        KFD._layer_operands(s, ws, rs, ra, hd=64, kv=4, with_tail=True,
                            with_mlp=True)


# ---------------------------------------------------------------------------
# K8 at N = 513 and K2 at hd = 544
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_ssa_attention_plain_long_sequence(causal):
    g, n, d = 2, 513, 16
    rng = np.random.default_rng(513 + causal)
    args = [(rng.random((g, n, d)) < p).astype(np.uint8) for p in (0.5, 0.6, 0.4)]
    args += [rng.integers(0, d, (g, n, n)).astype(np.int32),
             rng.integers(0, n, (g, n, d)).astype(np.int32)]
    want = JREF.ssa_attention_ref(*(jnp.asarray(a) for a in args),
                                  causal=causal)
    got = KS.ssa_attention_kernel(*(_t(a) for a in args), causal=causal)
    _eq(got, want)
    assert 0 < int(got.sum()) < got.numel()


def test_ssa_decode_plain_wide_head():
    g, l, d = 3, 40, 544
    rng = np.random.default_rng(544)
    q = rng.integers(0, 2, (g, 1, d)).astype(np.uint8)
    k = (rng.random((g, l, d)) < 0.5).astype(np.uint8)
    v = (rng.random((g, l, d)) < 0.5).astype(np.uint8)
    rs = rng.integers(0, d, (g, 1, l)).astype(np.int32)
    ra = rng.integers(0, l, (g, 1, d)).astype(np.int32)
    args = (q, k, v, rs, ra)
    want = JREF.ssa_decode_ref(*(jnp.asarray(a) for a in args))
    got = KS.ssa_decode_kernel(*(_t(a) for a in args))
    _eq(got, want)
    assert 0 < int(got.sum()) < got.numel()


@pytest.mark.parametrize("n,d,design", [
    (64, 64, "resident"), (37, 64, "resident"), (513, 64, "resident"),
    (1024, 64, "resident"), (2048, 512, "stream"), (65536, 64, "stream")])
def test_attention_plan(n, d, design):
    plan = KS.attention_plan(n, d)
    assert plan.design == design and plan.smem <= KS.SMEM_BUDGET
    if design == "stream":
        assert plan.rows % 8 == 0 and 8 <= plan.rows <= 64
        assert plan.keys % 32 == 0


def test_attention_plan_refuses_past_the_budget():
    with pytest.raises(ValueError, match=r"N=2000000, D=64 needs \d+ bytes"):
        KS.attention_plan(2_000_000, 64)


def test_keyed_attention_launcher_takes_the_wrappers_argtypes():
    """The keyed K8's ctypes parameters match its C launcher's signature
    type for type (a mismatch shows only on the card, as a wrong value)."""
    src = (Path(KS.__file__).parent / "csrc" / "ssa_attention.cu").read_text()
    sig = re.search(r'extern "C" int launch_ssa_attention_keyed\((.*?)\)',
                    src, re.S).group(1)
    ptr = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong))
    kinds = {"int": (ctypes.c_int,), "long long": (ctypes.c_longlong,),
             "unsigned long long": (ctypes.c_ulonglong,)}
    params = [" ".join(p.split()[:-1]) for p in sig.split(",")]
    assert len(params) == len(KS.KEYED_ARGTYPES) == 24
    for decl, got in zip(params, KS.KEYED_ARGTYPES):
        assert got in (ptr if "*" in decl else kinds[decl]), (decl, got)


# ---------------------------------------------------------------------------
# K1/K5 launch plans
# ---------------------------------------------------------------------------

# every (T, M, d_in, d_out) chip_smoke.py gives K1 or K5, then past them
PLAN_SHAPES = [
    (4, 1, 256, 256), (4, 1, 256, 1024), (4, 1, 1024, 256), (3, 5, 64, 48),
    (4, 4096, 384, 384), (4, 4096, 384, 1536), (4, 4096, 1536, 384),
    (4, 65536, 384, 384), (9, 4, 256, 256), (9, 4096, 384, 384),
    (4, 4, 512, 256), (4, 4, 128, 256), (4, 1, 512, 256), (4, 1, 128, 256),
    (3, 5, 130, 33), (9, 4, 512, 256), (16, 4, 512, 256), (4, 2368, 256, 256),
    (9, 65537, 130, 48), (9, 1, 130, 7), (70, 3, 64, 64), (1, 63, 5, 1),
    (4, 2176, 3072, 256), (64, 70000, 16, 48)]


@pytest.mark.parametrize("t,m,d_in,d_out", PLAN_SHAPES)
def test_launch_plan(t, m, d_in, d_out):
    """Many rows take the tensor-core GEMM, few rows the split of d_in; each
    plan keeps within the kernel's static buffers and covers every input
    row and output column."""
    plan = KA.launch_plan(t, m, d_in, d_out)
    if t * m >= KA.MMA_MIN_ROWS:
        assert plan == KA.LaunchPlan("mma", (0, 0, 0, 0))
        return
    cpt, ncgb, chain, ksplit = plan.split
    slots = 256 // ncgb
    assert plan.regime == "split" and d_out % cpt == 0
    assert ncgb in (8, 16, 32) and cpt in (1, 2, 4, 8, 16)
    assert t * m * cpt <= 64 and slots * chain * t * m <= 8192
    assert ksplit * slots * chain >= d_in and ksplit >= 1
    # no block along d_in is left without rows
    assert (ksplit - 1) * slots * chain < d_in


def test_launch_plan_serving_shapes_fill_the_card():
    """The mesh's decode tail and the prefill rows split d_in so that the
    weights stream from many blocks, 16 columns a thread where T*M allows."""
    assert KA.launch_plan(4, 1, 256, 256).split[0] == 16
    assert KA.launch_plan(4, 4, 512, 256) == KA.LaunchPlan(
        "split", (4, 32, 2, 32))
    cpt, ncgb, _, ksplit = KA.launch_plan(4, 1, 1024, 256).split
    assert -(-256 // (ncgb * cpt)) * ksplit >= 64  # the launcher's blocks


# ---------------------------------------------------------------------------
# The serve CLI's reference spellings
# ---------------------------------------------------------------------------


def test_serve_cli_takes_the_reference_spellings():
    ref = serve_cli.parse_args(["--arch", ARCH, "--pages", "64", "--full",
                                "--backend", "pallas"])
    own = serve_cli.parse_args(["--arch", ARCH, "--n-pages", "64", "--full",
                                "--backend", "cuda"])
    assert ref == own
    assert ref["n_pages"] == 64 and not ref["smoke"] and ref["backend"] == "cuda"
    # the reference's default is the reduced config; --pages 0 the default pool
    dflt = serve_cli.parse_args(["--arch", ARCH])
    assert dflt["smoke"] and dflt["n_pages"] is None
    assert serve_cli.parse_args(["--arch", ARCH, "--smoke"]) == dflt
    # the float backend (ported with training): its own name
    assert serve_cli.parse_args(["--arch", ARCH, "--backend", "reference"])[
        "backend"] == "reference"


def test_serve_cli_reference_command_runs_on_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--backend", "pallas", "--device", "cpu",
                    "--requests", "2", "--slots", "2", "--max-new", "2",
                    "--cache-len", "32", "--paged", "--pages", "12"])
    out = capsys.readouterr().out
    assert "served 2 requests, 4 tokens" in out and "12 pages of 8" in out


def test_serve_cli_takes_the_front_door_and_telemetry_flags(tmp_path,
                                                           monkeypatch):
    """``--http``, ``--host``, ``--port``, ``--trace-out``,
    ``--profile-steps`` and ``--profile-dir`` parse into ``serve``'s
    arguments; with ``--mesh`` they reach the ranks' job (caught here
    before a rank is spawned): ``--http`` makes it a front door job whose
    ranks run until Ctrl-C, the trace and the profiler are rank 0's."""
    from repro_torch.launch import mesh as LM

    class Spawned(Exception):
        pass

    def spawn(fn, shape, *, device, args, wait_s=None, **kw):
        raise Spawned(shape, args[0][0], wait_s)

    monkeypatch.setattr(LM, "run_ranks", spawn)
    kw = serve_cli.parse_args([
        "--arch", ARCH, "--http", "--host", "0.0.0.0", "--port", "9001",
        "--trace-out", str(tmp_path / "ev.jsonl"), "--profile-steps", "3",
        "--profile-dir", str(tmp_path / "prof")])
    assert (kw["http"], kw["host"], kw["port"], kw["profile_steps"]) == (
        True, "0.0.0.0", 9001, 3)
    assert kw["trace_out"].endswith("ev.jsonl")
    assert kw["profile_dir"].endswith("prof")
    dflt = serve_cli.parse_args(["--arch", ARCH])
    assert (dflt["http"], dflt["host"], dflt["port"], dflt["trace_out"],
            dflt["profile_steps"]) == (False, "127.0.0.1", 8000, "", 0)
    assert dflt["profile_dir"].endswith("xpike-profile")
    for extra, want in ((["--http"], {"kind": "front_door",
                                      "http": ("127.0.0.1", 8000)}),
                        (["--trace-out", "x.jsonl"], {"trace_out": "x.jsonl"}),
                        (["--profile-steps", "2"], {"profile_steps": 2})):
        with pytest.raises(Spawned) as got:
            serve_cli.main(["--arch", ARCH, "--device", "cpu", "--mesh",
                            "2x2", *extra])
        shape, job, wait_s = got.value.args
        assert shape == (2, 2)
        assert {k: job.get(k) for k in want} == want
        assert wait_s == (math.inf if "--http" in extra else None)
