"""The port's ``(data, model)`` mesh against the JAX package, on the CPU.

Ranks are processes spawned by :func:`repro_torch.launch.mesh.run_ranks`
over ``gloo`` (the rank functions live in ``tests/torch_mesh_jobs.py``,
which imports no JAX, so no rank does); the scenarios of one mesh shape
share one spawn.  On the reduced ``xpikeformer-gpt-4-256`` (2 layers, ``d=64``, 4
heads of 16, ``d_ff=128``), with JAX's weights carried over, everything
is compared bit for bit:

* K5's plain version against JAX's ``aimc_counts_ref`` and the Pallas
  ``aimc_matmul_counts_kernel`` in interpret mode (hypothesis shapes);
* on a ``(2, 2)`` mesh, one layer's column- and row-parallel linears
  against JAX's ``ShardedBackend`` on the 8-device host mesh and the
  port's single-device backends, and the head-parallel decode attention
  and fused layer (dense and paged) against one device, on both backends;
* scheduler runs on ``(2, 2)``: dense (5 ragged prompts through 2 slots)
  and paged (a 16-token shared prefix) against JAX's single-device
  ``IntegerBackend`` scheduler; programmed under a ``DriftPolicy``
  against the port's single device (tokens, folds, recalibrations,
  energy) and JAX (tokens); GDC of a cut tree against the whole tree;
  dense from a training checkpoint, each rank reading its serving
  placement, against JAX's tokens;
* a data-only ``(4, 1)`` and a model-only ``(1, 4)`` mesh, dense;
* ``parse_mesh_spec`` with JAX's cases, ``shard_params`` against JAX's
  placement, and a rank that raises failing ``run_ranks`` in time.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import aimc_device as JAD
from repro.configs import registry as JR
from repro.distributed import ShardedBackend as JShardedBackend
from repro.distributed import param_pspecs_for_tree
from repro.engine import IntegerBackend as JIntegerBackend
from repro.kernels import ops as JKOPS
from repro.kernels import ref as JKREF
from repro.launch.mesh import make_serving_mesh
from repro.launch.mesh import parse_mesh_spec as j_parse_mesh_spec
from repro.models import transformer as JT
from repro.serving import BatchScheduler as JBatchScheduler
from repro_torch import aimc_device as AD
from repro_torch import convert, prng
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry as R
from repro_torch.distributed import Executor, TPPlan
from repro_torch.engine import XpikeformerEngine, get_backend
from repro_torch.kernels import aimc_matmul as KA
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels import ref as KREF
from repro_torch.kernels.plan import KVView
from repro_torch.launch.mesh import ServingMesh, parse_mesh_spec, run_ranks
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.serving import BatchScheduler

import torch_mesh_jobs as MJ

ARCH = "xpikeformer-gpt-4-256"
LOW_SCATTER = dict(drift_nu_sigma=0.005, prog_noise_sigma=0.01)
TIMEOUT_S = 240.0  # per spawn; the whole file runs in well under this


# Executor.forward's batches: 4 rows split over data=2, 3 rows replicated
FWD_TOKENS = {b: np.random.default_rng(b).integers(0, 257, (b, 13))
              for b in (4, 3)}
FWD_KEY = 31


def _prompt(i, length):
    return list(range(3 + i, 3 + i + length))


PROMPTS = [_prompt(i, 3 + (2 * i) % 5) for i in range(5)]
SHARED = _prompt(9, 17)  # two full pages of context at page_len=8


def _eq(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got, want.astype(got.dtype)), \
        f"{what}: {int(np.sum(got != want))} elements differ"


@pytest.fixture(scope="module")
def setup():
    cfg = JR.reduced_config(ARCH)
    jparams = JT.init_params(jax.random.PRNGKey(0), cfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return cfg, R.reduced_config(ARCH), jparams, tparams


@pytest.fixture(scope="module")
def programmed(setup):
    """JAX's programmed tree (low-scatter devices) and the same in the
    port."""
    cfg, tcfg, jparams, _ = setup
    jacfg = JAD.AIMCConfig(**LOW_SCATTER)
    jhw = JAD.program_lm_tree(jax.random.PRNGKey(42), jparams, jacfg)
    thw = convert.params_from_numpy(jax.tree.map(np.asarray, jhw),
                                    device="cpu")
    return jhw, thw, jacfg, AD.AIMCConfig(**LOW_SCATTER)


def _drive(sch, prompts, max_new, seed0, wave=0, gap=0):
    """jobs.drive for a JAX or a port scheduler."""
    wave = wave or len(prompts)
    rids = []
    for i in range(0, len(prompts), wave):
        rids += [sch.submit(p, max_new, seed=seed0 + i + j)
                 for j, p in enumerate(prompts[i:i + wave])]
        for _ in range(gap):
            sch.step()
    out = sch.run()
    return [out[r] for r in rids]


def _jax_run(cfg, params, prompts, max_new, *, seed0=100, slots=2,
             cache_len=32, **kw):
    drive = {k: kw.pop(k) for k in ("wave", "gap") if k in kw}
    sch = JBatchScheduler(params, cfg, JIntegerBackend(), slots=slots,
                          cache_len=cache_len, **kw)
    return _drive(sch, prompts, max_new, seed0, **drive), sch


@pytest.fixture(scope="module")
def jax_dense(setup):
    """JAX's single-device integer scheduler on ``PROMPTS`` (5 new tokens
    each, seeds 100 + i): the streams every dense and paged mesh run must
    give, whatever its slot count."""
    cfg, _, jparams, _ = setup
    return _jax_run(cfg, jparams, PROMPTS, 5)


def _serve_job(tcfg, params, prompts, max_new, **kw):
    job = dict(cfg=tcfg, params=convert.params_to_numpy(params),
               prompts=prompts, max_new=max_new, slots=2, cache_len=32,
               seed0=100, backend="cuda")
    job.update(kw)
    return job


# ---------------------------------------------------------------------------
# K5: the crossbar counts
# ---------------------------------------------------------------------------


@settings(max_examples=8, deadline=None)
@given(t=st.integers(1, 4), m=st.integers(1, 9),
       d_in=st.sampled_from([8, 48, 130]), d_out=st.sampled_from([1, 33, 64]),
       seed=st.integers(0, 2**31 - 1))
def test_counts_plain_equals_jax_ref_and_pallas(t, m, d_in, d_out, seed):
    """K5's plain version == JAX's ``aimc_counts_ref`` == the Pallas
    ``aimc_matmul_counts_kernel`` (interpret mode), for binary spikes and
    for the integer-valued residual stream (counts up to 3 * 127 * d_in)."""
    rng = np.random.default_rng(seed)
    levels = rng.integers(-127, 128, (d_in, d_out)).astype(np.int8)
    for x in ((rng.random((t, m, d_in)) < 0.4).astype(np.float32),
              rng.integers(0, 4, (t, m, d_in)).astype(np.float32)):
        got = KREF.aimc_counts_ref(torch.from_numpy(x), torch.from_numpy(levels))
        _eq(got, JKREF.aimc_counts_ref(x, levels), "vs aimc_counts_ref")
        _eq(got, JKOPS.aimc_matmul_counts(jnp.asarray(x), jnp.asarray(levels)),
            "vs the Pallas kernel")
        assert got.dtype == torch.float32


def test_counts_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors ``aimc_matmul_counts_kernel`` and ``ops.
    aimc_matmul_counts`` run the plain version and count no launch."""
    from repro_torch.kernels import build as KB

    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.random((4, 5, 40)) < 0.5).astype(np.float32))
    lv = torch.from_numpy(rng.integers(-15, 16, (40, 24)).astype(np.int8))
    before = KB.LAUNCHES["aimc_matmul_counts"]
    want = KREF.aimc_counts_ref(x, lv)
    _eq(KA.aimc_matmul_counts_kernel(x, lv), want)
    _eq(KOPS.aimc_matmul_counts(x.to(torch.uint8), lv.to(torch.int32)), want)
    assert KB.LAUNCHES["aimc_matmul_counts"] == before


# ---------------------------------------------------------------------------
# The repaired backend API: h0 and with_tail
# ---------------------------------------------------------------------------


def _layer_ops(tparams, tcfg):
    """Layer 0's quantised operands, in ``_fused_block_weights`` order."""
    q = convert.layer_params(T.quantize_params(tparams, tcfg), tcfg, 0)
    return {"wq": q["mixer"]["wq"], "wk": q["mixer"]["wk"],
            "wv": q["mixer"]["wv"], "wo": q["mixer"]["wo"],
            "wi": q["mlp"]["wi"], "wo2": q["mlp"]["wo"]}


def _layer_inputs(tcfg, seed=5, b=3, l=24, page_len=8):
    """One layer's inputs as a server holds them: caches zero at and past
    each slot's position, page tables of private pages with a shared
    first page, an idle slot writing the trash page."""
    rng = np.random.default_rng(seed)
    t, d, h, kv, hd = (tcfg.spike_T, tcfg.d_model, tcfg.num_heads,
                       tcfg.num_kv_heads, tcfg.resolved_head_dim)
    pos = np.asarray([0, 9, 17], np.int32)
    sk = (rng.random((b, t, l, kv, hd)) < 0.4).astype(np.uint8)
    sv = (rng.random((b, t, l, kv, hd)) < 0.4).astype(np.uint8)
    for i, p in enumerate(pos):
        sk[i, :, p:] = 0
        sv[i, :, p:] = 0
    mp = l // page_len
    table = np.zeros((b, mp), np.int32)
    table[1, :2] = [2, 3]
    table[2, :3] = [2, 4, 5]  # page 2 shared by slots 1 and 2
    write = np.asarray([1, 3, 5], np.int32)  # slot 0 idle: the trash page
    kpool = (rng.random((7, t, kv, page_len, hd)) < 0.5).astype(np.uint8)
    vpool = (rng.random((7, t, kv, page_len, hd)) < 0.5).astype(np.uint8)
    kpool[0] = vpool[0] = 0
    kpool[3, :, :, 1:] = vpool[3, :, :, 1:] = 0  # slot 1 writes at 9
    kpool[5, :, :, 1:] = vpool[5, :, :, 1:] = 0  # slot 2 writes at 17
    pos_paged = np.asarray([0, 9, 17], np.int32)
    return dict(
        s=rng.integers(0, 3, (t, b, d)).astype(np.float32),
        x_rows=(rng.random((t, b, h * hd)) < 0.5).astype(np.float32),
        q=(rng.random((t, b, h, 1, hd)) < 0.5).astype(np.uint8),
        k=(rng.random((t, b, h, l, hd)) < 0.4).astype(np.uint8),
        v=(rng.random((t, b, h, l, hd)) < 0.4).astype(np.uint8),
        slot_keys=prng.key_from_seeds(torch.tensor([11, 12, 13])).numpy(),
        sk=sk, sv=sv, pos=pos, kpool=kpool, vpool=vpool, table=table,
        write_pids=write, pos_paged=pos_paged)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("backend", ["integer", "cuda"])
def test_fused_layer_without_tail_then_tail_equals_with_tail(
        setup, backend, paged):
    """One device: ``decode_layer_fused(with_tail=False)``, then the
    attention-out linear, residual and FFN tail as separate spiking
    linears, equals ``with_tail=True`` bit for bit; ``h0`` offsets select
    the global heads' draws (heads [2, 4) at ``h0=2`` equal the whole
    call's)."""
    _, tcfg, _, tparams = setup
    be = get_backend(backend)
    w = _layer_ops(tparams, tcfg)
    x = {k: torch.from_numpy(np.array(v)) for k, v in
         _layer_inputs(tcfg).items()}
    hd = tcfg.resolved_head_dim
    if paged:
        view = KVView.from_pool(x["kpool"], x["vpool"], x["table"])
        kw = dict(write_pids=x["write_pids"])
    else:
        view, kw = KVView.dense(x["sk"], x["sv"]), {}
    ws = [w[k] for k in ("wq", "wk", "wv", "wo", "wi", "wo2")]
    full = be.decode_layer_fused(x["slot_keys"], x["s"], view, x["pos"], *ws,
                                 hd=hd, **kw)
    a, kn, vn = be.decode_layer_fused(x["slot_keys"], x["s"], view, x["pos"],
                                      *ws[:3], hd=hd, with_tail=False, **kw)
    s1 = x["s"] + be.spiking_linear(w["wo"], a, part="row").float()
    h1 = be.spiking_linear(w["wi"], s1, part="col").float()
    s1 = s1 + be.spiking_linear(w["wo2"], h1, part="row").float()
    _eq(s1, full[0], "tail")
    _eq(kn, full[1], "k_new")
    _eq(vn, full[2], "v_new")
    # heads [2, 4) at h0 = 2: the whole call's attention train and KV rows
    half = {k: {"levels": v["levels"][:, 2 * hd:], "scale": v["scale"][2 * hd:]}
            for k, v in w.items() if k in ("wq", "wk", "wv")}
    if paged:
        hview = KVView.from_pool(x["kpool"][:, :, 2:], x["vpool"][:, :, 2:],
                                 x["table"])
    else:
        hview = KVView.dense(x["sk"][:, :, :, 2:], x["sv"][:, :, :, 2:])
    a2, kn2, _ = be.decode_layer_fused(
        x["slot_keys"], x["s"], hview, x["pos"], half["wq"], half["wk"],
        half["wv"], hd=hd, h0=2, with_tail=False, **kw)
    _eq(a2, a[..., 2 * hd:], "h0 = 2 attention")
    _eq(kn2, kn[:, :, 2:], "h0 = 2 k_new")


# ---------------------------------------------------------------------------
# The (2, 2) mesh: one spawn, every scenario
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh22(setup, programmed, tmp_path_factory):
    """Every (2, 2) scenario in one spawn; ``{name: [result per rank]}``."""
    _, tcfg, _, tparams = setup
    _, thw, _, tacfg = programmed
    ckpt = tmp_path_factory.mktemp("train_ckpt")
    CheckpointManager(ckpt).save(7, (tparams, A.init_opt_state(
        tparams, A.AdamWConfig())), blocking=True)
    ops = {k: convert.params_to_numpy(v)
           for k, v in _layer_ops(tparams, tcfg).items()}
    inputs = _layer_inputs(tcfg)
    inputs.pop("pos_paged")
    inputs["wo_bias"] = _wo_bias(tcfg)
    pol = AD.DriftPolicy(600.0, recal_interval_s=2400.0, cfg=tacfg)
    named = {
        "layer_integer": dict(kind="layer", cfg=tcfg, backend="integer",
                              ops=ops, inputs=inputs),
        "layer_cuda": dict(kind="layer", cfg=tcfg, backend="cuda", ops=ops,
                           inputs=inputs),
        "dense_integer": _serve_job(tcfg, tparams, PROMPTS, 5,
                                    backend="integer"),
        "dense_cuda": _serve_job(tcfg, tparams, PROMPTS, 5),
        # a training checkpoint's params, read with each rank's serving
        # placement (launch/elastic.state_shardings)
        "dense_checkpoint": dict(_serve_job(tcfg, tparams, PROMPTS, 5),
                                 params=None, ckpt=str(ckpt)),
        "paged": _serve_job(tcfg, tparams, PROMPTS, 5, paged=True,
                            page_len=8),
        "prefix": _serve_job(tcfg, tparams, [SHARED, SHARED], 4, paged=True,
                             page_len=8, seed0=1, wave=1, gap=25),
        "programmed": _serve_job(tcfg, thw, [_prompt(i, 3 + i)
                                             for i in range(4)], 6,
                                 backend="integer", drift=pol, seed0=10),
        # the full forward: a batch of 4 splits over data, one of 3 does
        # not (every rank runs it whole)
        "forward_cuda": dict(kind="forward", cfg=tcfg, backend="cuda",
                             params=convert.params_to_numpy(tparams),
                             tokens=FWD_TOKENS[4], key_seed=FWD_KEY),
        "forward_integer": dict(kind="forward", cfg=tcfg, backend="integer",
                                params=convert.params_to_numpy(tparams),
                                tokens=FWD_TOKENS[3], key_seed=FWD_KEY),
        "recalibrate": dict(kind="recalibrate", cfg=tcfg,
                            tree=convert.params_to_numpy(
                                AD.drift_tree(thw, 86400.0, tacfg)),
                            aimc_cfg=tacfg),
    }
    res = run_ranks(MJ.run_jobs, (2, 2), device="cpu",
                    args=(list(named.values()),), timeout_s=TIMEOUT_S)
    return {name: [r[i] for r in res] for i, name in enumerate(named)}


def _jax_linear(be, w, spikes, part):
    return np.asarray(be.spiking_linear(None, {"w": w, "b": None},
                                        jnp.asarray(spikes), part=part))


@pytest.fixture(scope="module")
def jax_linears(setup):
    """Layer 0's wq and MLP wi (column-parallel) and attention wo
    (row-parallel) through JAX's ``ShardedBackend`` on the (2, 2) host
    mesh, each checked against JAX's single device."""
    cfg, tcfg, jparams, _ = setup
    jsb = JShardedBackend(JIntegerBackend(), make_serving_mesh((2, 2)), cfg)
    blk = jax.tree.map(lambda a: a[0], jparams["periods"]["blk0"])
    d = cfg.d_model
    x = _layer_inputs(tcfg)
    out = {}
    for name, jw, spikes, part in (
            ("col_wq", blk["mixer"]["wq"].reshape(d, -1), x["s"], "col"),
            ("col_wi", blk["mlp"]["wi"], x["s"], "col"),
            ("row_wo", blk["mixer"]["wo"].reshape(-1, d), x["x_rows"], "row")):
        ref = _jax_linear(jsb, jw, spikes, part)
        _eq(ref, _jax_linear(JIntegerBackend(), jw, spikes, None),
            f"{name}: JAX sharded vs single")
        out[name] = (ref, spikes)
    return out


@pytest.mark.parametrize("backend", ["integer", "cuda"])
def test_mesh_linears_equal_jax_sharded_backend(setup, jax_linears, mesh22,
                                                backend):
    """The (2, 2) port mesh's column-parallel (wq, MLP wi) and
    row-parallel (attention wo: K5 counts summed over the model group, then
    LIF) linears == JAX's ``ShardedBackend`` on the host mesh == the
    port's single device, on every rank."""
    _, tcfg, _, tparams = setup
    w = _layer_ops(tparams, tcfg)
    one = get_backend(backend)
    for name, (ref, spikes) in jax_linears.items():
        single = one.spiking_linear(w[name[4:]], torch.from_numpy(spikes))
        _eq(single, ref, f"{name}: port single vs JAX")
        for rank, r in enumerate(mesh22[f"layer_{backend}"]):
            _eq(r[name], ref, f"{name} rank {rank}")


def _wo_bias(tcfg):
    """A dyadic bias for the attention-out linear (the LM stack's has
    none), which puts membranes on the threshold."""
    rng = np.random.default_rng(8)
    return (rng.integers(-4, 9, tcfg.d_model) / 8.0).astype(np.float32)


@pytest.mark.parametrize("backend", ["integer", "cuda"])
def test_mesh_row_epilogue_with_bias_equals_jax(setup, mesh22, backend):
    """The row-parallel epilogue with a bias -- the model group's summed
    counts through the backend's ``counts_lif`` (``* scale``, ``+ b``,
    LIF: one K4 launch on the card) -- on the (2, 2) mesh == JAX's
    ``ShardedBackend`` on the host mesh == the port's single device, on
    every rank."""
    cfg, tcfg, jparams, tparams = setup
    jsb = JShardedBackend(JIntegerBackend(), make_serving_mesh((2, 2)), cfg)
    blk = jax.tree.map(lambda a: a[0], jparams["periods"]["blk0"])
    bias = _wo_bias(tcfg)
    rows = _layer_inputs(tcfg)["x_rows"]
    ref = np.asarray(jsb.spiking_linear(
        None, {"w": blk["mixer"]["wo"].reshape(-1, cfg.d_model),
               "b": jnp.asarray(bias)}, jnp.asarray(rows), part="row"))
    wo = dict(_layer_ops(tparams, tcfg)["wo"], b=torch.from_numpy(bias))
    _eq(get_backend(backend).spiking_linear(wo, torch.from_numpy(rows)), ref,
        "port single vs JAX")
    for rank, r in enumerate(mesh22[f"layer_{backend}"]):
        _eq(r["row_wo_b"], ref, f"row_wo_b rank {rank}")


@pytest.mark.parametrize("backend", ["integer", "cuda"])
def test_mesh_head_parallel_attention_and_fused_layer(setup, mesh22,
                                                      backend):
    """Head-parallel decode attention (dense and paged) and the fused
    layer (dense with and without its tail, paged) on the (2, 2) mesh ==
    one device, on every rank."""
    _, tcfg, _, tparams = setup
    be = get_backend(backend)
    hd = tcfg.resolved_head_dim
    x = {k: torch.from_numpy(np.array(v)) for k, v in
         _layer_inputs(tcfg).items()}
    w = _layer_ops(tparams, tcfg)
    ws = [w[k] for k in ("wq", "wk", "wv", "wo", "wi", "wo2")]
    from repro_torch.kernels.plan import AttnSpec

    want = {"attn_dense": be.decode_attention(
        KVView.dense(x["k"], x["v"]), x["q"], AttnSpec(i_max=x["k"].shape[3]),
        slot_keys=x["slot_keys"])}
    l = x["table"].shape[1] * x["kpool"].shape[3]
    pview = KVView.from_pool(x["kpool"], x["vpool"], x["table"])
    want["attn_paged"] = be.decode_attention(
        pview, x["q"], AttnSpec(i_max=l), slot_keys=x["slot_keys"])
    dview = KVView.dense(x["sk"], x["sv"])
    for tail in (True, False):
        sfx = "" if tail else "_notail"
        out = be.decode_layer_fused(x["slot_keys"], x["s"], dview, x["pos"],
                                    *ws, hd=hd, with_tail=tail)
        for part, o in zip(("", "_k", "_v"), out):
            want[f"fused_dense{part}{sfx}"] = o
    out = be.decode_layer_fused(x["slot_keys"], x["s"], pview, x["pos"], *ws,
                                hd=hd, write_pids=x["write_pids"])
    for part, o in zip(("", "_k", "_v"), out):
        want[f"fused_paged{part}"] = o
    for rank, r in enumerate(mesh22[f"layer_{backend}"]):
        for name, v in want.items():
            _eq(r[name], v, f"{name} rank {rank}")


@pytest.mark.parametrize("backend", ["integer", "cuda"])
def test_mesh_dense_serve_equals_jax(jax_dense, mesh22, backend):
    """5 ragged prompts through 2 slots (admissions and evictions
    mid-flight) on the (2, 2) mesh: JAX's single-device integer tokens on
    every rank, 5 admissions and evictions, ``(data_shards,
    model_shards) == (2, 2)``."""
    ref, jsch = jax_dense
    assert jsch.stats.admissions == 5 and jsch.stats.evictions == 5
    for r in mesh22[f"dense_{backend}"]:
        assert r["outputs"] == ref
        st = r["stats"]
        assert (st["admissions"], st["evictions"]) == (5, 5)
        assert (st["data_shards"], st["model_shards"]) == (2, 2)
        assert r["fused"] and r["backend"] == f"sharded[{backend}]"


def test_mesh_serves_a_training_checkpoint(jax_dense, mesh22):
    """Each rank restores a training checkpoint ``(params, opt_state)``
    with its serving placement (the parameters only) and serves JAX's
    single-device tokens."""
    ref, _ = jax_dense
    for r in mesh22["dense_checkpoint"]:
        assert r["outputs"] == ref
        assert (r["stats"]["data_shards"], r["stats"]["model_shards"]) == (2, 2)
        assert r["fused"] and r["backend"] == "sharded[cuda]"


@pytest.mark.parametrize("backend,b", [("cuda", 4), ("integer", 3)])
def test_mesh_forward_equals_one_device(setup, mesh22, backend, b):
    """``Executor.forward`` on the (2, 2) mesh: every rank's logits equal
    one device's ``engine.forward`` bit for bit, with the batch split over
    ``data`` (4 rows) and replicated (3 rows); the single device agrees
    with JAX's forward within float rounding."""
    cfg, tcfg, jparams, tparams = setup
    eng = XpikeformerEngine.from_config(tcfg, backend=backend, device="cpu")
    tokens = torch.from_numpy(FWD_TOKENS[b])
    want = eng.forward(tokens, prng.PRNGKey(FWD_KEY), tparams)
    for r in mesh22[f"forward_{backend}"]:
        _eq(r["logits"], want.numpy(), f"mesh forward, batch {b}")
        assert r["backend"] == f"sharded[{backend}]"
    jlogits, _ = JT.forward(jparams, {"tokens": jnp.asarray(FWD_TOKENS[b])},
                            cfg, rng=jax.random.PRNGKey(FWD_KEY),
                            backend=JIntegerBackend(), remat="none")
    np.testing.assert_allclose(want.numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-4)


def test_mesh_paged_serve_and_prefix_hits_equal_jax(setup, jax_dense,
                                                     mesh22):
    """Paged on the (2, 2) mesh (pool whole on each data rank, KV heads
    split over model): JAX's single-device tokens; a request sharing a
    16-token context with a finished one hits the prefix cache exactly as
    JAX's paged scheduler does."""
    cfg, _, jparams, _ = setup
    ref, _ = jax_dense
    for r in mesh22["paged"]:
        assert r["outputs"] == ref
    pref, psch = _jax_run(cfg, jparams, [SHARED, SHARED], 4, seed0=1, wave=1,
                          gap=25, paged=True, page_len=8)
    assert psch.stats.prefix_hit_tokens == 16
    for r in mesh22["prefix"]:
        assert r["outputs"] == pref
        assert (r["stats"]["prefix_hits"], r["stats"]["prefix_hit_tokens"]) \
            == (psch.stats.prefix_hits, psch.stats.prefix_hit_tokens)


def test_mesh_programmed_drift_serve_equals_single_device(setup, programmed,
                                                          mesh22):
    """Programmed PCM under ``DriftPolicy(600, 2400)`` on the (2, 2) mesh
    (each rank folds its shares; GDC sums its reads over the model group):
    the port's single-device tokens, clock, folds, recalibrations and
    energy, bit for bit, and JAX's tokens."""
    cfg, tcfg, _, _ = setup
    jhw, thw, jacfg, tacfg = programmed
    prompts = [_prompt(i, 3 + i) for i in range(4)]
    sch = BatchScheduler(thw, tcfg, "integer", slots=2, cache_len=32,
                         device="cpu", drift=AD.DriftPolicy(
                             600.0, recal_interval_s=2400.0, cfg=tacfg))
    ref = _drive(sch, prompts, 6, 10)
    assert sch.stats.recalibrations >= 2
    jref, _ = _jax_run(cfg, jhw, prompts, 6, seed0=10, drift=JAD.DriftPolicy(
        600.0, recal_interval_s=2400.0, cfg=jacfg))
    assert ref == jref
    want = dataclasses.asdict(sch.stats)
    keys = ("t_device_s", "image_folds", "recalibrations", "energy_j",
            "spike_events", "decode_steps", "decoded_tokens")
    for r in mesh22["programmed"]:
        assert r["outputs"] == ref
        assert {k: r["stats"][k] for k in keys} == {k: want[k] for k in keys}
        assert r["request_energy_j"] == [sch.request_energy_j[k]
                                         for k in sorted(sch.request_energy_j)]


def test_mesh_recalibrate_of_cut_tree_equals_whole(programmed, mesh22):
    """GDC of a tree cut over the model group (per-rank integer reads
    summed) measures the whole tree's gains on every rank."""
    _, thw, _, tacfg = programmed
    whole = AD.recalibrate_tree(AD.drift_tree(thw, 86400.0, tacfg), tacfg)
    want = [s.gdc_gain.numpy() for s in AD.device_states(whole)]
    assert len(want) == 6 and not np.allclose(want[0], 1.0)
    for r in mesh22["recalibrate"]:
        assert len(r) == len(want)
        for got, w in zip(r, want):
            _eq(got, w, "gdc_gain")


# ---------------------------------------------------------------------------
# Data-only and model-only meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 1), (1, 4)])
def test_dp_only_and_tp_only_meshes_equal_jax(setup, jax_dense, shape):
    """A data-only (4, 1) mesh (4 slots, one a rank; the inner backend
    unwrapped) and a model-only (1, 4) mesh (one head a rank) serve JAX's
    single-device tokens (a stream does not depend on the slot count)."""
    _, tcfg, _, tparams = setup
    ref, _ = jax_dense
    res = run_ranks(MJ.run_jobs, shape, device="cpu", args=([_serve_job(
        tcfg, tparams, PROMPTS, 5, slots=4)],), timeout_s=TIMEOUT_S)
    for (r,) in res:
        assert r["outputs"] == ref
        assert (r["stats"]["data_shards"], r["stats"]["model_shards"]) == shape
        assert r["backend"] == ("cuda" if shape[1] == 1 else "sharded[cuda]")


# ---------------------------------------------------------------------------
# Entry points, placement, failure
# ---------------------------------------------------------------------------


def test_parse_mesh_spec_matches_jax():
    for spec in ("2x4", "2,4", "4", "1x8"):
        assert parse_mesh_spec(spec) == j_parse_mesh_spec(spec)
    assert parse_mesh_spec("auto")[1] == 1
    with pytest.raises(ValueError):
        parse_mesh_spec("2x2x2")


def test_engine_executor_on_a_one_rank_mesh(setup):
    """``XpikeformerEngine.executor`` on the (1, 1) mesh of one process
    (no process group) serves the engine's own tokens, and its
    ``forward`` gives the engine's logits."""
    _, tcfg, _, tparams = setup
    eng = XpikeformerEngine.from_config(tcfg, backend="integer", device="cpu")
    eng.params = tparams
    want, _ = eng.serve(PROMPTS, 5, slots=2, cache_len=32, seed=100)
    ex = eng.executor(ServingMesh.single("cpu"))
    got, stats = ex.serve(PROMPTS, 5, slots=2, cache_len=32, seed=100)
    assert got == want and (stats.data_shards, stats.model_shards) == (1, 1)
    tokens = torch.arange(24, dtype=torch.int64).reshape(2, 12) % 257
    key = prng.PRNGKey(8)
    assert torch.equal(ex.forward(tokens, key), eng.forward(tokens, key))
    if not torch.cuda.is_available():  # the one-rank mesh defaults to CUDA
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingMesh.single()
    # the executor serves on the engine's device: a rank elsewhere is refused
    with pytest.raises(ValueError, match="mesh rank runs on"):
        eng.executor(ServingMesh((1, 1), 0, torch.device("meta")))


def test_shard_params_equals_jax_placement(setup, programmed):
    """Each model rank's share of a programmed tree is JAX's placement
    slice of the same state (``param_pspecs_for_tree`` on a (1, 2) mesh):
    matrix fields by columns or rows, ``scale`` by columns only, the
    clock, GDC gain and image grid whole; a cut tree is not cut again."""
    cfg, tcfg, _, _ = setup
    jhw, thw, _, _ = programmed
    specs = param_pspecs_for_tree(cfg, jhw, make_serving_mesh((1, 2)))
    for m in range(2):
        mine = convert.shard_params(thw, tcfg, 2, m)
        blk, jblk = mine["periods"]["blk0"], jhw["periods"]["blk0"]
        sblk = specs["periods"]["blk0"]
        for grp, name in (("mixer", "wq"), ("mixer", "wk"), ("mixer", "wv"),
                          ("mixer", "wo"), ("mlp", "wi"), ("mlp", "wo")):
            st_, jst, sp = blk[grp][name], jblk[grp][name], sblk[grp][name]
            for f in dataclasses.fields(st_):
                want = np.asarray(getattr(jst, f.name))
                spec = tuple(getattr(sp, f.name))
                for ax, a in enumerate(spec):
                    if a == "model":
                        n = want.shape[ax] // 2
                        want = np.take(want, range(m * n, (m + 1) * n), ax)
                _eq(getattr(st_, f.name), want, f"{grp}.{name}.{f.name}")
        with pytest.raises(ValueError, match="not the whole matrix"):
            convert.shard_params(mine, tcfg, 2, m)


def test_uneven_split_raises():
    """A model axis that does not divide the heads is refused (no silent
    replication)."""
    cfg = R.reduced_config(ARCH)
    with pytest.raises(NotImplementedError, match="must divide"):
        TPPlan.from_config(cfg, 3).require(cfg)
    with pytest.raises(NotImplementedError, match="must divide"):
        Executor(T.init_params(cfg, 0, "cpu"), cfg, "integer",
                 ServingMesh((1, 3), 0, torch.device("cpu")))


def test_a_failing_rank_fails_run_ranks_in_time():
    """A rank that raises fails ``run_ranks`` with its traceback while the
    other rank waits in a collective: no hang."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        run_ranks(MJ.run_jobs, (1, 2), device="cpu",
                  args=([{"kind": "fail", "rank": 1}],), timeout_s=60)
    assert time.perf_counter() - t0 < 60
