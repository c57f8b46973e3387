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

The float and MoE stacks on the mesh (reduced configs, the port's weights
carried to JAX through numpy; float32 outputs within ``ATOL``, token
streams and spikes exact), in the same spawns:

* MoE's expert-parallel ``_ep_local`` (the all-to-all over the model
  group) on ``(2, 2)`` against JAX's ``moe_ep`` under ``shard_map`` with
  the executor's ``pctx`` on the host mesh, given JAX's routing, at
  capacity factor 1.25 and at one where both capacities drop;
* the reduced phi3.5-moe: three teacher-forced ``decode_step``s on
  ``(2, 2)`` against JAX's with the executor's ``pctx``; served on
  ``(1, 4)`` against JAX's ``Executor`` and on ``(2, 2)`` (where JAX's
  executor raises) against one device;
* yi-9b, mamba2-780m and recurrentgemma-9b served on ``(2, 2)`` against
  JAX's ``Executor``; ``Executor.forward`` of yi-9b and phi3.5-moe on
  ``(2, 2)`` against JAX's, and of pixtral-12b's embeddings against JAX's
  forward on one device;
* an uneven split: the reduced phi3.5-moe as a spiking SSA stack (one KV
  head: the attention is held whole) on ``(2, 2)``, its forward and its
  dense and paged streams against JAX's ``Executor``;
* ``convert.shard_params``'s expert blocks against JAX's in-spec slices.

Training on the mesh (reduced configs, the port's weights carried to JAX
through numpy, one ``MarkovStream`` batch of 8), in the same spawns: one
step of ``launch``-style ``make_train_step`` on each rank's cut of the
state, against JAX's ``make_train_step`` jitted with ``make_pctx`` on
``make_test_mesh`` of the same shape -- each rank's updated leaves and
AdamW moments against the matching block of JAX's, and its loss,
``xent``, ``moe_aux`` and gradient norm:

* phi3.5-moe on ``(2, 2)`` at sequence 32 (the token gather and the
  outputs' ``psum_scatter``) and 64 (the weight gather), and on ``(1,
  4)`` at 64, where the reference's per-device capacities make its step
  differ from one device's;
* yi-9b as it stands (one KV head: its query heads cut beside it) and
  with two KV heads (both head axes cut);
* the spiking GPT on ``(2, 2)`` and ``(1, 4)``, whose ``(1, 4)`` loss is
  the port's one device's bit for bit (the row-parallel sums only decide
  spikes);
* the train launcher's rank function for 4 steps on ``(2, 2)`` with a
  checkpoint at step 2, resumed on one device and on ``(1, 4)``, and a
  one-device checkpoint resumed on ``(2, 2)``;
* the port's training placement against JAX's ``param_pspecs``.

The JAX references compile in a pool of threads while the ranks run
(``mesh_refs``).
"""

import asyncio
import dataclasses
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor

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
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ParallelConfig as JParallel
from repro.launch.mesh import make_test_mesh
from repro.optim import adamw as JA
from repro.parallel import sharding as JSH
from repro.train import loop as JL
from repro.distributed import Executor as JExecutor
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serving import BatchScheduler as JBatchScheduler
from repro_torch import aimc_device as AD
from repro_torch import convert, prng
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ModelConfig, ParallelConfig
from repro_torch.configs import registry as R
from repro_torch.distributed import Executor, TPPlan
from repro_torch.engine import XpikeformerEngine, get_backend
from repro_torch.kernels import aimc_matmul as KA
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels import ref as KREF
from repro_torch.checkpoint.manager import leaves as ckpt_leaves
from repro_torch.checkpoint.manager import map_with_placement
from repro_torch.data.pipeline import DataConfig, MarkovStream
from repro_torch.kernels.plan import KVView
from repro_torch.launch import train as LT
from repro_torch.launch.mesh import ServingMesh, parse_mesh_spec, run_ranks
from repro_torch.parallel import sharding as SH
from repro_torch.train import loop as TL
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.server import TenantPolicy
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


# float32 outputs of the float and MoE stacks (einsum and exp round in
# other orders than XLA's); the spiking stack's logits against JAX's (the
# rate coding's sigmoid, layernorm and the unembed are float boundaries)
ATOL = 1e-5
SPIKE_ATOL = 1e-4
MOE = "phi3.5-moe-42b-a6.6b"
SPIKING_MOE = "phi3.5-moe-spiking"
FLOATS = ("yi-9b", "mamba2-780m", "recurrentgemma-9b")
MOE_PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9], [10, 11, 12, 13],
               [5, 5, 5, 5, 5]]
SERVE = dict(max_new=4, slots=4, cache_len=16, seed0=0)
STACK_TOKENS = np.random.default_rng(21).integers(0, 257, (4, 8)).astype(
    np.int32)
FRONT = "pixtral-12b"  # a frontend arch: its forward takes embeddings
STACK_EMBED = np.random.default_rng(22).standard_normal((4, 8, 24)).astype(
    np.float32)
EP_SHAPE, EP_CFS = (4, 16, 16), (1.25, 0.5)

# one training step on a mesh against JAX's on ``make_test_mesh``: the loss,
# ``xent`` and ``moe_aux`` (means summed over ranks and in other orders),
# the gradient norm relative to itself, each moment against its leaf's
# largest entry (the moments hold the gradient: ``m = 0.1 g``, ``v = 0.05
# g^2``), and each updated parameter: AdamW's first step moves a weight by
# ``lr * g / (|g| + eps)``: within one device's ``2e-2 * lr``
# (tests/test_torch_optim.py) where JAX's ``|g|`` exceeds
# ``TRAIN_TINY_GRAD``; below it a rounding of ``g`` (which the moments'
# tolerance admits) can move the update by up to its whole size, ``lr``,
# so there within ``2 * lr``
TRAIN_LOSS_ATOL = 1e-5
TRAIN_NORM_RTOL = 1e-5
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_PARAM_ATOL = 2e-2 * TRAIN_OPT["lr"]
TRAIN_TINY_GRAD = 1e-6
TRAIN_MOMENT_RTOL = 1e-4
TRAIN_CASES = {  # name: (arch, mesh shape, sequence, config change,
    #                        ParallelConfig change)
    "moe_tokens": (MOE, (2, 2), 32, {}, {}),
    "moe_weights": (MOE, (2, 2), 64, {}, {}),
    "moe_model": (MOE, (1, 4), 64, {}, {}),
    "moe_nofsdp": (MOE, (2, 2), 64, {}, {"fsdp": False}),
    "moe_pure_dp": (MOE, (2, 2), 32, {}, {"pure_dp": True}),
    "yi_whole": ("yi-9b", (2, 2), 32, {}, {}),
    "yi_heads": ("yi-9b", (2, 2), 32, {"num_kv_heads": 2}, {}),
    "gpt22": (ARCH, (2, 2), 32, {}, {}),
    "gpt14": (ARCH, (1, 4), 32, {}, {}),
}
# the train launcher on the mesh: 4 steps, a checkpoint every 2
LAUNCH = dict(smoke=True, steps=4, batch=8, seq_len=16, ckpt_every=2,
              fail_at=-1, straggler_factor=3.0, seed=0, log_every=0,
              lr=1e-3, probe=False)
# the front door over the mesh: ``PROMPTS`` as three tenants (request
# ``i`` is tenant ``i % 3``); ``metered`` holds a joule bucket of
# ``FD_BUCKET`` of its request's cost (JAX's dense run), refilled at
# ``FD_REFILL`` buckets a second only once it has been preempted; two
# waves with an idle gap of several heartbeats between them
FD_TENANTS = {"interactive": dict(priority=0), "batch": dict(priority=1),
              "metered": dict(priority=1, preempt=True)}
FD_BUCKET, FD_REFILL = 0.25, 50.0
FD_HEARTBEAT_S, FD_IDLE_S = 0.1, 0.6


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


def _fd_job(tcfg, tparams, jax_dense, **kw):
    """The spiking GPT's front door job (``FD_*``) on ``PROMPTS``."""
    _, jsch = jax_dense
    bucket = FD_BUCKET * float(jsch.request_energy_j[2])  # request 2: metered
    tenants = dict(FD_TENANTS)
    tenants["metered"] = dict(tenants["metered"], energy_budget_j=bucket)
    return _serve_job(tcfg, tparams, PROMPTS, 5, kind="front_door",
                      tenants=tenants,
                      refill_on_preempt={"metered": FD_REFILL * bucket},
                      waves=[3, 2], idle_s=FD_IDLE_S,
                      heartbeat_s=FD_HEARTBEAT_S, **kw)


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
# The float and MoE stacks: configs, weights and the JAX references
# ---------------------------------------------------------------------------


_STACKS = {}


def _stack(arch):
    """``(jcfg, tcfg, JAX params, the port's)``: the port's
    ``init_params(seed 0)`` carried to JAX through numpy."""
    if arch not in _STACKS:
        if arch == SPIKING_MOE:
            change = dict(spiking=True, attention_kind="ssa", spike_T=4)
            jcfg, tcfg = (dataclasses.replace(reg.reduced_config(MOE),
                                              **change) for reg in (JR, R))
        else:
            jcfg, tcfg = JR.reduced_config(arch), R.reduced_config(arch)
        tp = T.init_params(tcfg, 0, "cpu")
        jp = jax.tree.map(jnp.asarray, convert.params_to_numpy(tp))
        _STACKS[arch] = (jcfg, tcfg, jp, tp)
    return _STACKS[arch]


def _ep_cfgs(cf):
    j = JModelConfig(name="ep", family="moe", num_layers=1, d_model=16,
                     num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=64,
                     num_experts=8, moe_top_k=2, capacity_factor=cf,
                     dtype="float32")
    return j, ModelConfig(**dataclasses.asdict(j))


def _ep_inputs():
    """numpy MoE leaves ``normal / sqrt(fan)`` and the input ``x``."""
    rng = np.random.default_rng(4)
    params = {n: (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
        np.float32) for n, (shape, _) in M.moe_schema(_ep_cfgs(1.0)[1]).items()}
    return params, rng.standard_normal(EP_SHAPE).astype(np.float32)


def _jax_serve(arch, shape):
    """JAX's executor on ``shape`` (``None``: one device's scheduler) on
    ``MOE_PROMPTS`` with the port's weights."""
    jcfg, _, jp, _ = _stack(arch)
    if shape is None:
        sch = JBatchScheduler(jp, jcfg, slots=SERVE["slots"],
                              cache_len=SERVE["cache_len"])
        return _drive(sch, MOE_PROMPTS, SERVE["max_new"], SERVE["seed0"])
    ex = JExecutor(jp, jcfg, "integer", make_serving_mesh(shape))
    return ex.serve(MOE_PROMPTS, SERVE["max_new"], slots=SERVE["slots"],
                    cache_len=SERVE["cache_len"], seed=SERVE["seed0"])[0]


def _jax_spiking():
    """JAX's executor on (2, 2) for the spiking MoE: the forward's logits
    and the dense and paged streams (``IntegerBackend``)."""
    jcfg, _, jp, _ = _stack(SPIKING_MOE)
    ex = JExecutor(jp, jcfg, "integer", make_serving_mesh((2, 2)))
    logits = np.asarray(ex.forward(jnp.asarray(STACK_TOKENS),
                                   jax.random.PRNGKey(FWD_KEY)))
    kw = dict(slots=SERVE["slots"], cache_len=SERVE["cache_len"],
              seed=SERVE["seed0"])
    dense = ex.serve(MOE_PROMPTS, SERVE["max_new"], **kw)[0]
    paged = ex.serve(MOE_PROMPTS, SERVE["max_new"], paged=True, page_len=8,
                     **kw)[0]
    return logits, dense, paged


def _jax_forward(arch):
    """JAX's ``Executor.forward`` on (2, 2); a frontend arch's forward of
    its embeddings on one device (JAX's executor takes tokens only)."""
    jcfg, _, jp, _ = _stack(arch)
    if arch == FRONT:
        return np.asarray(jax.jit(lambda p, e: JT.forward(
            p, {"embeddings": e}, jcfg, remat="none")[0])(jp, STACK_EMBED))
    ex = JExecutor(jp, jcfg, "integer", make_serving_mesh((2, 2)))
    return np.asarray(ex.forward(jnp.asarray(STACK_TOKENS),
                                 jax.random.PRNGKey(FWD_KEY)))


def _jax_decode():
    """Three teacher-forced steps of JAX's ``decode_step`` with the
    executor's ``pctx`` on the (2, 2) host mesh (4 slots)."""
    jcfg, _, jp, _ = _stack(MOE)
    pctx = JExecutor(jp, jcfg, "integer", make_serving_mesh((2, 2))).pctx
    step = jax.jit(lambda p, c, t: JT.decode_step(p, c, t, jcfg, pctx,
                                                  moe_impl="ep_a2a"))
    cache = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype),
                         JT.cache_schema(jcfg, 4, 3))
    out = []
    for i in range(3):
        logits, cache = step(jp, cache, STACK_TOKENS[:, i:i + 1])
        out.append(np.asarray(logits))
    return np.concatenate(out, 1)


def _jax_ep(cf, x):
    jcfg, _ = _ep_cfgs(cf)
    params, _ = _ep_inputs()
    pctx = JM.ParallelCtx(mesh=make_serving_mesh((2, 2)), dp_axes=("data",),
                          fsdp_axis=None, tp_axis="model", seq_shard=False)
    return np.asarray(jax.jit(lambda p, v: JM.moe_ep(
        p, v, jcfg, pctx, seq_sharded=False)[0])(params, x))


_TRAIN = {}


def _train_case(name):
    """``(jcfg, tcfg, numpy params, tokens [8, S+1])`` of a train case:
    the port's ``init_params(seed 0)`` and ``MarkovStream`` batch 0."""
    if name not in _TRAIN:
        arch, _, seq, change, _ = TRAIN_CASES[name]
        jcfg, tcfg = (dataclasses.replace(reg.reduced_config(arch), **change)
                      for reg in (JR, R))
        params = convert.params_to_numpy(T.init_params(tcfg, 0, "cpu"))
        tokens = MarkovStream(DataConfig(tcfg.vocab_size, seq, 8, seed=0),
                              device="cpu").batch_at(0)["tokens"].numpy()
        _TRAIN[name] = (jcfg, tcfg, params, tokens)
    return _TRAIN[name]


def _jax_train(name):
    """JAX's ``make_train_step`` (``remat="none"``, ``moe_impl="ep_a2a"``,
    the launcher's) jitted with ``make_pctx(make_test_mesh(shape))``, one
    step from fresh moments with key ``fold_in(PRNGKey(0), 0)``: numpy
    ``(params, opt_state, metrics)``."""
    jcfg, _, params, tokens = _train_case(name)
    _, shape, _, _, pchange = TRAIN_CASES[name]
    par = JParallel(remat="none", moe_impl="ep_a2a", **pchange)
    opt = JA.AdamWConfig(**TRAIN_OPT)
    jp = jax.tree.map(jnp.asarray, params)
    step = jax.jit(JL.make_train_step(
        jcfg, JSH.make_pctx(make_test_mesh(shape), par), par, opt))
    out = step(jp, JA.init_opt_state(jp, opt),
               {"tokens": jnp.asarray(tokens)},
               jax.random.fold_in(jax.random.PRNGKey(0), 0))
    return jax.tree.map(np.asarray, out)


def _train_job(name):
    _, tcfg, params, tokens = _train_case(name)
    return dict(kind="train", cfg=tcfg, params=params, tokens=tokens,
                key_seed=0, opt=TRAIN_OPT, return_state=True,
                parallel=dict(remat="none", moe_impl="ep_a2a",
                              **TRAIN_CASES[name][4]))


def _one_device_step(name):
    """The port's one-device step of a train case -> its metrics (on one
    torch thread: thousands of tiny ops)."""
    _, tcfg, params, tokens = _train_case(name)
    opt = A.AdamWConfig(**TRAIN_OPT)
    p = convert.params_from_numpy(params, "cpu")
    step = TL.make_train_step(tcfg, ParallelConfig(remat="none"), opt)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return step(p, A.init_opt_state(p, opt),
                    {"tokens": torch.from_numpy(tokens)},
                    prng.fold_in(prng.PRNGKey(0), 0))[2]
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ep_routing():
    """JAX's router outputs ``(weights, idx)`` on the ``_ep_local`` case,
    per capacity factor (the routing does not depend on it)."""
    params, x = _ep_inputs()
    jcfg, _ = _ep_cfgs(1.0)
    w, idx, _ = JM.router(params, x, jcfg)
    return np.asarray(w), np.asarray(idx)


@pytest.fixture(scope="module")
def mesh_refs():
    """The JAX references of the float and MoE stacks, submitted to a
    pool of threads (XLA compiles in parallel) before the ranks spawn;
    ``{name: future}``."""
    _, x = _ep_inputs()
    for arch in FLOATS + (MOE, SPIKING_MOE, FRONT):
        _stack(arch)
    jobs = {("ep", cf): (_jax_ep, cf, x) for cf in EP_CFS}
    jobs["decode"] = (_jax_decode,)
    jobs["serve14"] = (_jax_serve, MOE, (1, 4))
    jobs["serve1"] = (_jax_serve, MOE, None)
    jobs.update({("serve22", a): (_jax_serve, a, (2, 2)) for a in FLOATS})
    jobs.update({("forward", a): (_jax_forward, a)
                 for a in ("yi-9b", MOE, FRONT)})
    jobs["spiking"] = (_jax_spiking,)
    for n in TRAIN_CASES:
        _train_case(n)
    jobs.update({("train", n): (_jax_train, n) for n in TRAIN_CASES})
    pool = ThreadPoolExecutor(max_workers=os.cpu_count() or 4)
    yield {k: pool.submit(*v) for k, v in jobs.items()}
    pool.shutdown(wait=True)


def _stack_jobs(ep_routing):
    """The float and MoE stacks' rank jobs of the (2, 2) spawn."""
    params, x = _ep_inputs()
    w, idx = ep_routing
    named = {f"ep_{cf}": dict(kind="ep_local", cfg=_ep_cfgs(cf)[1],
                              params=params, x=x, weights=w, idx=idx)
             for cf in EP_CFS}

    def serve(arch, **kw):
        return _serve_job(_stack(arch)[1], _stack(arch)[3], MOE_PROMPTS,
                          backend="cuda", **dict(SERVE, **kw))

    moe = _stack(MOE)
    named["moe_decode"] = dict(kind="decode", cfg=moe[1],
                               params=convert.params_to_numpy(moe[3]),
                               tokens=STACK_TOKENS, steps=3)
    named["moe_serve"] = serve(MOE)
    named.update({f"serve_{a}": serve(a) for a in FLOATS})
    for a in ("yi-9b", MOE, SPIKING_MOE):
        named[f"forward_{a}"] = dict(
            kind="forward", cfg=_stack(a)[1], backend="cuda",
            params=convert.params_to_numpy(_stack(a)[3]),
            tokens=STACK_TOKENS, key_seed=FWD_KEY)
    named[f"forward_{FRONT}"] = dict(
        kind="forward", cfg=_stack(FRONT)[1],
        params=convert.params_to_numpy(_stack(FRONT)[3]),
        embeddings=STACK_EMBED, key_seed=FWD_KEY)
    named["spiking_dense"] = serve(SPIKING_MOE)
    named["spiking_paged"] = serve(SPIKING_MOE, paged=True, page_len=8)
    return named


# ---------------------------------------------------------------------------
# The (2, 2) mesh: one spawn, every scenario
# ---------------------------------------------------------------------------


def _step2_copy(src, dst):
    """``dst``: a copy of the launcher's checkpoint directory ``src`` that
    holds only its step-2 checkpoint (what a resume from step 2 reads)."""
    import shutil

    dst.mkdir(parents=True, exist_ok=True)
    shutil.copytree(src / "step_00000002", dst / "step_00000002")
    (dst / "LATEST").write_text("2")
    return str(dst)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The launcher on one device in this process: 4 uninterrupted steps
    (the losses every mesh run is held to), whose step-2 checkpoint the
    (2, 2) mesh resumes."""
    root = tmp_path_factory.mktemp("launch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # thousands of tiny ops: one torch thread
    try:
        full = LT.run(ARCH, ckpt_dir=str(root / "one"), restore=False,
                      device="cpu", **LAUNCH)
    finally:
        torch.set_num_threads(threads)
    return {"root": root, "losses": full,
            "from_one": _step2_copy(root / "one", root / "from_one")}


@pytest.fixture(scope="module")
def mesh22(setup, programmed, jax_dense, tmp_path_factory, mesh_refs,
           ep_routing, launched):
    """Every (2, 2) scenario in one spawn; ``{name: [result per rank]}``
    (``jax_dense`` first: it compiles before ``mesh_refs``'s pool takes
    the cores)."""
    _, tcfg, _, tparams = setup
    _, thw, _, tacfg = programmed
    ckpt = tmp_path_factory.mktemp("train_ckpt")
    root = launched["root"]
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
        **_stack_jobs(ep_routing),
        **{f"train_{n}": _train_job(n) for n, c in TRAIN_CASES.items()
           if c[1] == (2, 2)},
        "fd_dense": _fd_job(tcfg, tparams, jax_dense),
        "fd_paged": _fd_job(tcfg, tparams, jax_dense, paged=True,
                            page_len=8),
        "launch": dict(kind="launch", arch=ARCH, kw=dict(
            LAUNCH, ckpt_dir=str(root / "mesh22"), restore=False)),
        "launch_from_one": dict(kind="launch", arch=ARCH, kw=dict(
            LAUNCH, ckpt_dir=launched["from_one"], restore=True)),
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
# The float and MoE stacks on the mesh
# ---------------------------------------------------------------------------


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("cf", EP_CFS)
def test_ep_all_to_all_equals_jax_shard_map(mesh_refs, mesh22, cf):
    """Each rank's ``_ep_local`` over its data block of the rows, its block
    of experts and the all-to-all over its model group, given JAX's
    routing, == JAX's ``moe_ep`` under ``shard_map`` on the (2, 2) host
    mesh with the executor's ``pctx`` within ``ATOL``, with the same rows
    zeroed.  At factor 0.5 choices drop past ``cap`` and past ``C2`` (the
    model group's copies of each token count against ``C2``)."""
    want = mesh_refs["ep", cf].result()
    zero_j = np.all(want == 0, axis=-1)
    past = np.zeros(2, np.int64)
    for rank, r in enumerate(mesh22[f"ep_{cf}"]):
        _close(r["y"], want, what=f"rank {rank}")
        np.testing.assert_array_equal(np.all(r["y"] == 0, axis=-1), zero_j)
        past += [r["drops"]["past_cap"], r["drops"]["past_c2"]]
    if cf < 1:
        assert past.min() > 0 and zero_j.any()
    else:
        assert past.sum() == 0 and not zero_j.any()


def test_moe_decode_steps_equal_jax_pctx(mesh_refs, mesh22):
    """Three teacher-forced ``decode_step``s of the reduced phi3.5-moe on
    the (2, 2) mesh (2 slots a data rank, the dispatch over the model
    group) == JAX's ``decode_step(..., pctx=Executor.pctx)`` on the host
    mesh, within ``ATOL``, on every rank."""
    want = mesh_refs["decode"].result()
    for rank, r in enumerate(mesh22["moe_decode"]):
        _close(r["logits"], want, what=f"rank {rank}")
        assert [d["past_cap"] + d["past_c2"] for d in r["drops"]] == [0] * 3


def test_moe_serve_on_a_model_mesh_equals_jax_executor(mesh_refs, mesh14):
    """The reduced phi3.5-moe served on the (1, 4) mesh (one expert a
    rank) == JAX's ``Executor`` on the (1, 4) host mesh, on every rank."""
    want = mesh_refs["serve14"].result()
    for r in mesh14:
        assert r[1]["outputs"] == want
        assert r[1]["backend"] == "cuda" and not r[1]["fused"]


def test_moe_serve_with_data_split_equals_one_device(mesh_refs, mesh22):
    """The reduced phi3.5-moe served on the (2, 2) mesh: the streams of the
    port's one device and JAX's, and no rank drops a choice.  JAX's
    ``Executor`` raises here (its batch-1 prefill cannot split over
    ``data``, ``repro/models/moe.py:322``): the port routes a prefill's
    token over the model group alone (``serving/state.py:
    make_prefill_fn``)."""
    _, tcfg, _, tp = _stack(MOE)
    want = mesh_refs["serve1"].result()
    sch = BatchScheduler(tp, tcfg, slots=SERVE["slots"],
                         cache_len=SERVE["cache_len"], device="cpu")
    assert _drive(sch, MOE_PROMPTS, SERVE["max_new"], SERVE["seed0"]) == want
    for r in mesh22["moe_serve"]:
        assert r["outputs"] == want
        assert (r["moe"]["past_cap"], r["moe"]["past_c2"]) == (0, 0)
        assert r["moe"]["by_tokens"][1]["all_to_alls"] > 0  # the prefills


@pytest.mark.parametrize("arch", FLOATS)
def test_float_serve_on_mesh_equals_jax_executor(mesh_refs, mesh22, arch):
    """yi-9b (dense), mamba2-780m (SSD) and recurrentgemma-9b (RG-LRU and
    a windowed attention) served on the (2, 2) mesh, their caches whole
    over ``model``: JAX's ``Executor`` streams on the host mesh, no
    joules."""
    want = mesh_refs["serve22", arch].result()
    for r in mesh22[f"serve_{arch}"]:
        assert r["outputs"] == want
        assert r["stats"]["energy_j"] == 0.0
        assert (r["stats"]["data_shards"], r["stats"]["model_shards"]) == (2, 2)


@pytest.mark.parametrize("arch", ["yi-9b", MOE, FRONT])
def test_float_and_moe_forward_on_mesh_equal_jax(mesh_refs, mesh22, arch):
    """``Executor.forward`` on the (2, 2) mesh: yi-9b's rows split over
    ``data``, phi3.5-moe's whole batch on every rank with one device's
    capacities (its experts' products split) == JAX's ``Executor.forward``
    within ``ATOL``, on every rank; pixtral-12b's embeddings (rows split)
    == JAX's forward of them on one device (JAX's executor takes tokens
    only)."""
    want = mesh_refs["forward", arch].result()
    for rank, r in enumerate(mesh22[f"forward_{arch}"]):
        _close(r["logits"], want, what=f"rank {rank}")


def test_uneven_spiking_split_equals_jax_executor(mesh_refs, mesh22):
    """The reduced phi3.5-moe as a spiking SSA stack on the (2, 2) mesh:
    one KV head does not split over ``model = 2``, so the attention is
    held whole on every rank (and the MoE tail, ``moe_dense`` on the rate
    interface, is row by row).  The forward's logits equal one device's
    bit for bit and JAX's ``Executor.forward`` within ``SPIKE_ATOL``; the
    dense and paged streams equal JAX's ``Executor`` streams."""
    jlogits, jdense, jpaged = mesh_refs["spiking"].result()
    _, tcfg, _, tp = _stack(SPIKING_MOE)
    eng = XpikeformerEngine.from_config(tcfg, backend="integer", device="cpu")
    eng.params = tp
    want = eng.forward(torch.from_numpy(STACK_TOKENS).long(),
                       prng.PRNGKey(FWD_KEY)).numpy()
    _close(want, jlogits, SPIKE_ATOL)
    for rank in range(4):
        _eq(mesh22[f"forward_{SPIKING_MOE}"][rank]["logits"], want,
            f"forward rank {rank}")
        assert mesh22["spiking_dense"][rank]["outputs"] == jdense
        assert mesh22["spiking_paged"][rank]["outputs"] == jpaged
        assert mesh22["spiking_dense"][rank]["backend"] == "sharded[cuda]"


def test_shard_params_expert_blocks_equal_jax_in_spec(setup):
    """``convert.shard_params`` of a float MoE tree on a model axis of 2:
    each rank's ``wi``/``wg``/``wo`` are JAX's slices under ``moe_ep``'s
    in-spec ``P("model", None, None)`` (a period axis ahead), the router
    and attention whole; ``param_placement`` cuts the same leaves; a
    model size that does not divide ``E`` raises."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro_torch.parallel import sharding as SH

    jcfg, tcfg, jp, tp = _stack(MOE)
    jmesh = make_serving_mesh((1, 2))
    for m in range(2):
        mine = convert.shard_params(tp, tcfg, 2, m)["periods"]["blk0"]
        for name in ("wi", "wg", "wo"):
            leaf = jax.device_put(jp["periods"]["blk0"]["moe"][name],
                                  NamedSharding(jmesh, P(None, "model")))
            shard = [s for s in leaf.addressable_shards
                     if s.device == jmesh.devices[0, m]][0]
            _eq(mine["moe"][name], np.asarray(shard.data), f"{name} {m}")
        assert mine["moe"]["router"] is tp["periods"]["blk0"]["moe"]["router"]
        assert mine["mixer"]["wq"] is tp["periods"]["blk0"]["mixer"]["wq"]
    place = SH.param_placement(tcfg, (1, 2), device="cpu", model_index=1,
                               serving=True)["periods"]["blk0"]
    assert {n: p.part for n, p in place["moe"].items()} == {
        "router": None, "wi": "experts", "wg": "experts", "wo": "experts"}
    assert place["mixer"]["wq"].whole
    with pytest.raises(ValueError, match="do not split"):
        convert.shard_params(tp, tcfg, 3, 0)


# ---------------------------------------------------------------------------
# Data-only and model-only meshes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh14(setup, mesh_refs, launched, mesh22):
    """The (1, 4) spawn: the spiking dense serve, then phi3.5-moe's, the
    (1, 4) train cases, the (2, 2) launcher run resumed from its step-2
    checkpoint, and phi3.5-moe through the front door (two tenants)."""
    _, tcfg, _, tparams = setup
    moe = _stack(MOE)
    root = launched["root"]
    todo = [_serve_job(tcfg, tparams, PROMPTS, 5, slots=4),
            _serve_job(moe[1], moe[3], MOE_PROMPTS, **SERVE),
            *[_train_job(n) for n, c in TRAIN_CASES.items()
              if c[1] == (1, 4)],
            dict(kind="launch", arch=ARCH, kw=dict(
                LAUNCH, restore=True, ckpt_dir=_step2_copy(
                    root / "mesh22", root / "from_mesh22_14"))),
            _serve_job(moe[1], moe[3], MOE_PROMPTS, kind="front_door",
                       tenants={"interactive": {}, "batch": dict(priority=1)},
                       **SERVE)]
    return run_ranks(MJ.run_jobs, (1, 4), device="cpu", args=(todo,),
                     timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("shape", [(4, 1), (1, 4)])
def test_dp_only_and_tp_only_meshes_equal_jax(setup, jax_dense, shape,
                                              request):
    """A data-only (4, 1) mesh (4 slots, one a rank; the inner backend
    unwrapped) and a model-only (1, 4) mesh (one head a rank) serve JAX's
    single-device tokens (a stream does not depend on the slot count)."""
    _, tcfg, _, tparams = setup
    ref, _ = jax_dense
    if shape == (1, 4):
        res = [r[:1] for r in request.getfixturevalue("mesh14")]
    else:
        res = run_ranks(MJ.run_jobs, shape, device="cpu", args=([_serve_job(
            tcfg, tparams, PROMPTS, 5, slots=4)],), timeout_s=TIMEOUT_S)
    for (r,) in res:
        assert r["outputs"] == ref
        assert (r["stats"]["data_shards"], r["stats"]["model_shards"]) == shape
        assert r["backend"] == ("cuda" if shape[1] == 1 else "sharded[cuda]")


# ---------------------------------------------------------------------------
# The front door over the mesh (rank 0 serves, every rank steps)
# ---------------------------------------------------------------------------


_FD_SAME = ("requests", "decode_steps", "decoded_tokens", "prefill_tokens",
            "admissions", "evictions", "spike_events", "energy_j",
            "prefix_hits", "prefix_hit_tokens", "cow_copies")


def _metric(text, name):
    """A sample's value in Prometheus text (``name`` with its labels)."""
    (line,) = [ln for ln in text.splitlines() if ln.split(" ")[0] == name]
    return float(line.split(" ")[1])


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_mesh_front_door_streams_equal_jax(jax_dense, mesh22, layout):
    """The reduced spiking GPT served through the front door on the (2, 2)
    mesh, rank 0 taking HTTP requests from three tenants and the other
    ranks following: every SSE stream equals JAX's serve of the same
    prompt and seed, the preempted ``metered`` request included (its
    replay passed the bit check); every rank's scheduler ends with rank
    0's outputs and stats; rank 0 alone holds telemetry and trace
    events; ``/metrics`` after the last ``done`` reads no running and no
    queued request and one TTFT a request."""
    want, _ = jax_dense
    res = mesh22[f"fd_{layout}"]
    r0 = res[0]
    assert r0["streams"] == want and r0["errors"] == [None] * len(want)
    assert [d["tokens"] for d in r0["done"]] == want
    results = {r["request_id"]: r for r in r0["results"]}
    assert len(results) == len(want)
    preempted = {r["tenant"] for r in results.values() if r["preemptions"]}
    assert preempted == {"metered"} and r0["preemptions"] >= 1
    decisions = [r["decision"] for r in r0["records"]]
    assert "preempt:energy" in decisions and "readmit" in decisions
    for rank, r in enumerate(res):
        assert r["outputs"] == r0["outputs"], rank
        assert {k: r["stats"][k] for k in _FD_SAME} == \
            {k: r0["stats"][k] for k in _FD_SAME}, rank
        assert r["request_energy_j"] == r0["request_energy_j"], rank
        assert r["telemetry"] == (rank == 0)
        assert ("events" in r) == (rank == 0)
        if rank:  # a follower stepped exactly when rank 0 did
            assert r["followed"]["steps"] == r0["stats"]["decode_steps"]
    events = {(e["event"], e["fid"]) for e in r0["events"] if "fid" in e}
    for fid in results:
        assert {("admit", fid), ("first_token", fid),
                ("finish", fid)} <= events
    text = r0["metrics"]
    assert _metric(text, "xpike_frontdoor_running") == 0
    assert _metric(text, "xpike_frontdoor_queue_depth") == 0
    assert _metric(text, "xpike_ttft_seconds_count") == len(want)
    assert r0["stats_http"]["scheduler"]["decoded_tokens"] == \
        r0["stats"]["decoded_tokens"]


def test_mesh_front_door_idle_gap_heartbeats(mesh22):
    """Between the two waves the front door idles for ``FD_IDLE_S``, six
    heartbeats: no rank steps, every follower takes the no-ops and never
    waits in one broadcast for as long as the gap (so a group timeout
    longer than a few heartbeats is never reached), and the second wave
    is served."""
    for layout in ("dense", "paged"):
        res = mesh22[f"fd_{layout}"]
        idle = res[0]["idle"]
        assert idle["steps"] == 0 and idle["seconds"] >= FD_IDLE_S
        for r in res[1:]:
            followed = r["followed"]
            assert followed["noops"] >= FD_IDLE_S / FD_HEARTBEAT_S / 2
            assert followed["longest_wait_s"] < FD_IDLE_S


def test_mesh_front_door_moe_equals_jax_executor(mesh_refs, mesh14):
    """The reduced phi3.5-moe through the front door on the (1, 4) mesh,
    its experts' all-to-all in every step: rank 0's streams equal JAX's
    ``Executor``, every rank's outputs and stats equal rank 0's, and no
    rank drops a choice (at 4 slots no batch can fill a capacity)."""
    want = mesh_refs["serve14"].result()
    res = [r[-1] for r in mesh14]
    assert res[0]["streams"] == want and res[0]["errors"] == [None] * 5
    for r in res:
        assert r["outputs"] == res[0]["outputs"]
        assert {k: r["stats"][k] for k in _FD_SAME} == \
            {k: res[0]["stats"][k] for k in _FD_SAME}
        assert (r["moe"]["past_cap"], r["moe"]["past_c2"]) == (0, 0)


@dataclasses.dataclass
class _RecordingMesh(ServingMesh):
    """A one-rank mesh that keeps what rank 0 broadcast; past
    ``fail_at`` broadcasts it raises, as a collective with a dead peer
    does."""

    sent: list = dataclasses.field(default_factory=list)
    fail_at: int = -1

    def broadcast_bytes(self, payload):
        if len(self.sent) == self.fail_at:
            raise RuntimeError("Connection closed by peer")
        self.sent.append(payload)
        return payload


class _Replay:
    """A follower's side of ``_RecordingMesh``: rank 0's broadcasts."""

    rank = 1

    def __init__(self, sent):
        self._sent = iter(sent)

    def broadcast_bytes(self, payload):
        return next(self._sent)


def _door(sch, policies, idle_s=0.0):
    """``PROMPTS`` (5 new tokens, seeds 100 + i, tenant ``i % 3`` of
    ``FD_TENANTS``) submitted before the front door's pump starts, so its
    decisions do not depend on timing; served, then idle ``idle_s``.
    -> (streams or the error each raised, the front door, trace events)."""
    from repro_torch.obs import ListSink, Telemetry
    from repro_torch.server import FrontDoor

    obs = Telemetry.create()
    sink = ListSink()
    obs.tracer.add_sink(sink)

    async def go():
        front = FrontDoor(sch, telemetry=obs, policies=policies)
        streams = [await front.submit(p, 5, seed=100 + i,
                                      tenant=list(FD_TENANTS)[i % 3])
                   for i, p in enumerate(PROMPTS)]
        await front.start()
        got = []
        try:
            for ts in streams:
                try:
                    got.append(await ts.tokens())
                except RuntimeError as e:
                    got.append(str(e))
            await asyncio.sleep(idle_s)
        finally:
            try:
                await front.stop()
            except RuntimeError as e:
                got.append(f"stop: {e}")
        return got, front

    got, front = asyncio.run(go())
    return got, front, sink.events


def _strip(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "mono", "ttft_s",
                                                        "latency_s")}
            for e in events]


def test_one_rank_mesh_leader_equals_plain_front_door(setup, jax_dense):
    """No spawn: the front door over a ``MeshLeader`` on a one-rank mesh
    gives the plain front door's streams, results, admission records and
    trace events (JAX's tokens); it broadcasts once a step, no-ops while
    idle and a STOP last.  Replayed through ``follow`` into a fresh
    scheduler, those broadcasts give the same outputs and stats; replayed
    into a scheduler that already took a request, the first submit's rid
    differs and ``follow`` raises."""
    import pickle

    from repro_torch.server import MeshLeader, follow
    from repro_torch.server import mesh as SM

    _, tcfg, _, tparams = setup
    want, _ = jax_dense
    policies = {n: TenantPolicy(**kw) for n, kw in FD_TENANTS.items()}

    def sched():
        return BatchScheduler(tparams, tcfg, "integer", slots=2,
                              cache_len=32, device="cpu")

    plain = sched()
    got, front, events = _door(plain, policies)
    mesh = _RecordingMesh((1, 1), 0, torch.device("cpu"))
    lead = sched()
    got_l, front_l, events_l = _door(
        MeshLeader(lead, mesh, heartbeat_s=0.05), policies, idle_s=0.4)
    assert got == got_l == want
    assert lead.obs is front_l.obs and lead.obs is not None
    for a, b in zip(front.results, front_l.results):
        assert (a.request_id, a.tenant, a.tokens, a.energy_j,
                a.preemptions) == (b.request_id, b.tenant, b.tokens,
                                   b.energy_j, b.preemptions)
    assert list(front.adm.records) == list(front_l.adm.records)
    assert _strip(events) == _strip(events_l)
    ops = [pickle.loads(b)[1] for b in mesh.sent]
    assert ops.count(SM.STEP) == lead.stats.decode_steps
    assert ops[-1] == SM.STOP and ops.count(SM.STOP) == 1
    assert ops.count(SM.NOOP) >= 3  # the idle 0.4 s, a no-op each 0.05 s
    follower = sched()
    followed = follow(follower, _Replay(mesh.sent))
    assert followed["steps"] == lead.stats.decode_steps
    assert follower.outputs == lead.outputs
    assert follower.request_energy_j == lead.request_energy_j
    for k in _FD_SAME:
        assert getattr(follower.stats, k) == getattr(lead.stats, k), k
    ahead = sched()
    ahead.submit(PROMPTS[0], 5)
    with pytest.raises(RuntimeError, match="diverged"):
        follow(ahead, _Replay(mesh.sent))


def test_a_dead_follower_fails_the_mesh_front_door(setup):
    """No spawn: when rank 0's broadcast raises (a follower died), every
    open stream ends with the pump's error, ``stop`` raises, and the
    leader sends no STOP into the broken mesh."""
    from repro_torch.server import MeshLeader

    _, tcfg, _, tparams = setup
    sch = BatchScheduler(tparams, tcfg, "integer", slots=2, cache_len=32,
                         device="cpu")
    mesh = _RecordingMesh((1, 1), 0, torch.device("cpu"), fail_at=3)
    lead = MeshLeader(sch, mesh)
    got, front, _ = _door(lead, {})
    *streams, stopped = got
    assert len(streams) == len(PROMPTS)
    assert all(isinstance(g, str) and "front door pump failed" in g
               and "Connection closed" in g for g in streams)
    assert stopped == "stop: Connection closed by peer"
    assert front.failed == len(PROMPTS) and front.completed == 0
    assert lead.broken and lead.closed and len(mesh.sent) == 3


def test_serve_cli_front_door_on_a_mesh(setup, tmp_path, monkeypatch,
                                        capsys):
    """``launch.serve`` with ``--mesh --http --trace-out`` no longer
    raises: it runs a front door job on the ranks (here one rank, run in
    this process in place of the spawn), which serves HTTP until SIGINT,
    stops the followers and returns rank 0's summary; rank 0's trace
    sink holds the request's lifecycle."""
    import signal
    import socket
    import threading

    from repro_torch.launch import mesh as LM
    from repro_torch.launch import serve as LS
    from repro_torch.obs import load_jsonl
    from repro_torch.server import generate

    spawned = {}

    def one_rank(fn, shape, *, device, args, wait_s=None, **kw):
        spawned.update(shape=shape, wait_s=wait_s, job=args[0][0])
        return [fn(ServingMesh.single(device), *args)]

    monkeypatch.setattr(LM, "run_ranks", one_rank)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = {}

    def client():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                got["stream"] = asyncio.run(generate(
                    "127.0.0.1", port, dict(prompt=PROMPTS[0], max_new=5,
                                            seed=100)))
                break
            except OSError:
                time.sleep(0.05)
        os.kill(os.getpid(), signal.SIGINT)

    trace = tmp_path / "events.jsonl"
    t = threading.Thread(target=client, daemon=True)
    t.start()
    out = LS.serve(ARCH, smoke=True, mesh="1x1", http=True, port=port,
                   device="cpu", backend="integer", slots=2, cache_len=32,
                   trace_out=str(trace))
    t.join(timeout=10)
    assert not t.is_alive() and out == []
    assert spawned["wait_s"] == math.inf
    assert spawned["job"]["kind"] == "front_door"
    toks, done, error = got["stream"]
    assert error is None and done["tokens"] == toks and len(toks) == 5
    text = capsys.readouterr().out
    assert "rank 0 served HTTP" in text and "served 1 requests" in text
    kinds = {e["event"] for e in load_jsonl(str(trace))}
    assert {"submit", "admit", "first_token", "finish"} <= kinds


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


def test_uneven_split_raises(setup):
    """A model axis that divides neither the heads nor ``d_ff`` (3 of 4
    heads, ``d_ff = 128``): every spiking linear is held whole, as JAX's
    ``TPPlan`` finds nothing to split and its placement replicates every
    leaf; the rank's executor (no collective is needed) serves and
    forwards one device's tokens and logits, bit for bit, and within
    ``SPIKE_ATOL`` of JAX's forward.  A model axis of 2 splits the MLP
    only when the heads do not (``TPPlan.splits``)."""
    from repro.distributed.backend import TPPlan as JTPPlan

    cfg, tcfg, jparams, tparams = setup
    plan, jplan = TPPlan.from_config(tcfg, 3), JTPPlan.from_config(cfg, 3)
    assert (plan.heads, jplan.heads) == (False, False)
    assert not plan.splits("mlp") and not jplan.col_ok(cfg.d_ff)
    specs = param_pspecs_for_tree(cfg, jparams, make_serving_mesh((1, 3)))
    assert all(s == jax.sharding.PartitionSpec() for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    ex = Executor(tparams, tcfg, "integer",
                  ServingMesh((1, 3), 1, torch.device("cpu")))
    whole = T.quantize_params(tparams, tcfg, keep_state=True)
    blk, wblk = ex.params["periods"]["blk0"], whole["periods"]["blk0"]
    for grp, name in (("mixer", "wq"), ("mixer", "wo"), ("mlp", "wo")):
        _eq(blk[grp][name]["levels"], wblk[grp][name]["levels"].numpy())
    eng = XpikeformerEngine.from_config(tcfg, backend="integer", device="cpu")
    eng.params = tparams
    tokens = torch.from_numpy(FWD_TOKENS[4])
    key = prng.PRNGKey(FWD_KEY)
    want = eng.forward(tokens, key)
    _eq(ex.forward(tokens, key), want.numpy(), "held-whole forward")
    assert ex.serve(PROMPTS, 5, slots=2, cache_len=32, seed=100)[0] == \
        eng.serve(PROMPTS, 5, slots=2, cache_len=32, seed=100)[0]
    jlogits, _ = JT.forward(jparams, {"tokens": jnp.asarray(FWD_TOKENS[4])},
                            cfg, rng=jax.random.PRNGKey(FWD_KEY),
                            backend=JIntegerBackend(), remat="none")
    np.testing.assert_allclose(want.numpy(), np.asarray(jlogits), rtol=0,
                               atol=SPIKE_ATOL)
    # heads that split, an MLP that does not: each part by its own rule
    odd = dataclasses.replace(tcfg, d_ff=129)
    p2 = TPPlan.from_config(odd, 2)
    assert p2.splits("mixer") and not p2.splits("mlp")


def test_a_failing_rank_fails_run_ranks_in_time():
    """A rank that raises fails ``run_ranks`` with its traceback while the
    other rank waits in a collective: no hang."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        run_ranks(MJ.run_jobs, (1, 2), device="cpu",
                  args=([{"kind": "fail", "rank": 1}],), timeout_s=60)
    assert time.perf_counter() - t0 < 60


# ---------------------------------------------------------------------------
# Training on the mesh
# ---------------------------------------------------------------------------


def _train_results(name, mesh22, mesh14):
    """Each rank's result of the train case ``name``."""
    if TRAIN_CASES[name][1] == (2, 2):
        return mesh22[f"train_{name}"]
    at = 2 + [n for n, c in TRAIN_CASES.items()
              if c[1] == (1, 4)].index(name)
    return [r[at] for r in mesh14]


def _blocks(tree, place):
    return map_with_placement(
        lambda x, where, field: x if where.whole else where.piece(x, field),
        tree, place)


def _cut_close(got, want, place, what, *, atol=None, rtol_of_max=None,
               grads=None):
    """Each leaf of a rank's ``got`` against its block of ``want`` (the
    rank's ``place``ment of the whole tree): within ``atol``, or
    ``rtol_of_max`` of the leaf's largest entry; with ``grads`` (JAX's
    first moments, ``0.1 g``) within ``2 * lr`` where ``|g|`` is below
    ``TRAIN_TINY_GRAD`` (see ``TRAIN_PARAM_ATOL``)."""
    block = _blocks(want, place)
    gblock = None if grads is None else _blocks(grads, place)

    def walk(g, w, m, path):
        if isinstance(g, dict):
            assert set(g) == set(w), path
            for k in g:
                walk(g[k], w[k], None if m is None else m[k], f"{path}/{k}")
            return
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        tol = atol if atol is not None else rtol_of_max * max(
            float(np.max(np.abs(w))), 1e-30)
        if m is not None:
            tiny = np.abs(np.asarray(m, np.float32)) / 0.1 < TRAIN_TINY_GRAD
            tol = np.where(tiny, 2 * TRAIN_OPT["lr"], tol)
        assert np.all(np.abs(g - w) <= tol), \
            f"{what}{path}: {float(np.max(np.abs(g - w)))}"

    walk(got, block, gblock, what)


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_mesh_train_step_equals_jax(mesh_refs, mesh22, mesh14, name):
    """One train step on the mesh, each rank on its cut of the state, ==
    JAX's ``make_train_step`` on ``make_test_mesh`` of the same shape:
    every rank's updated leaves and AdamW moments against the matching
    block of JAX's (``TRAIN_PARAM_ATOL``, ``TRAIN_MOMENT_RTOL``), and its
    loss, ``xent`` and ``moe_aux`` (``TRAIN_LOSS_ATOL``) and gradient norm
    (``TRAIN_NORM_RTOL``).  The MoE cases take the reference's un-cut
    branch: the token gather at sequence 32, the weight gather at 64, none
    without a data axis or FSDP; with ``pure_dp`` every leaf is whole and
    the batch rows split over every rank."""
    _, shape, _, _, pchange = TRAIN_CASES[name]
    jp, js, jm = mesh_refs["train", name].result()
    _, tcfg, _, _ = _train_case(name)
    res = _train_results(name, mesh22, mesh14)
    assert len(res) == shape[0] * shape[1]
    for rank, r in enumerate(res):
        m = r["metrics"][0]
        for k in ("loss", "xent", "moe_aux"):
            assert abs(m[k] - float(jm[k])) <= TRAIN_LOSS_ATOL, (rank, k)
        np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]),
                                   rtol=TRAIN_NORM_RTOL)
        place = SH.param_placement(tcfg, shape, device="cpu",
                                   data_index=rank // shape[1],
                                   model_index=rank % shape[1], **pchange)
        _cut_close(r["params"], jp, place, f"rank {rank} params",
                   atol=TRAIN_PARAM_ATOL, grads=js["m"])
        for mom in ("m", "v"):
            _cut_close(r[mom], js[mom], place, f"rank {rank} {mom}",
                       rtol_of_max=TRAIN_MOMENT_RTOL)
        if tcfg.is_moe:
            branches = {b for d in r["dispatch"][0]["by_tokens"].values()
                        for b in d["branches"]}
            want = {"moe_tokens": "tokens", "moe_weights": "weights"}.get(
                name, "none")
            assert branches == {want}, (rank, branches)
    held = [r["held"] for r in res]
    whole = sum(np.asarray(x).size for x in jax.tree.leaves(jp))
    if pchange.get("pure_dp"):
        assert held == [whole] * len(res)
    else:
        assert max(held) < whole


def test_mesh_moe_train_differs_from_one_device_as_jax(mesh_refs, mesh22,
                                                       mesh14):
    """At (1, 4) the reference's capacities are per device (``T_l`` the
    rank's quarter of the sequence), so its step differs from one
    device's (the port's one-device step, which equals JAX's:
    ``tests/test_torch_moe.py``) -- and the port's mesh step is the
    reference's, not one device's."""
    _, _, jm = mesh_refs["train", "moe_model"].result()
    one = float(_one_device_step("moe_model")["loss"])
    assert abs(float(jm["loss"]) - one) > 100 * TRAIN_LOSS_ATOL
    r = _train_results("moe_model", mesh22, mesh14)[0]
    assert abs(r["metrics"][0]["loss"] - one) > 100 * TRAIN_LOSS_ATOL


def test_spiking_model_mesh_loss_is_one_devices_bit_for_bit(mesh22, mesh14):
    """The spiking GPT's (1, 4) step: the heads' SSA draws and the
    row-parallel currents give one device's spikes, so the loss is the
    port's one-device loss bit for bit (only the gradients' float sums
    are split)."""
    m = _one_device_step("gpt14")
    for r in _train_results("gpt14", mesh22, mesh14):
        assert r["metrics"][0]["loss"] == float(m["loss"])
        assert r["metrics"][0]["xent"] == float(m["xent"])


def test_launcher_on_the_mesh_resumes_across_meshes(launched, mesh22,
                                                    mesh14, tmp_path):
    """The launcher's rank function on (2, 2): 4 steps with checkpoints
    at 2 and 4 (gathered whole, the reference's files) within
    ``TRAIN_LOSS_ATOL`` of one device's losses; its step-2 checkpoint
    resumed on one device and on (1, 4), and one device's resumed on (2,
    2): steps 2-3 match; the final checkpoint agrees leaf for leaf with
    one device's steps 2-3 from its step-2 checkpoint."""
    want = launched["losses"]
    mesh = mesh22["launch"]
    for r in mesh:
        np.testing.assert_allclose(r["losses"], want, rtol=0,
                                   atol=TRAIN_LOSS_ATOL)
    for r in mesh22["launch_from_one"]:
        assert r["start_step"] == 2
        np.testing.assert_allclose(r["losses"], want[2:], rtol=0,
                                   atol=TRAIN_LOSS_ATOL)
    for r in mesh14:
        assert r[-2]["start_step"] == 2
        np.testing.assert_allclose(r[-2]["losses"], mesh[0]["losses"][2:],
                                   rtol=0, atol=TRAIN_LOSS_ATOL)
    root = launched["root"]
    ckpt = _step2_copy(root / "mesh22", tmp_path / "resume")
    report = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = LT.run(ARCH, ckpt_dir=ckpt, restore=True, device="cpu",
                     report=report, **LAUNCH)
    finally:
        torch.set_num_threads(threads)
    assert report["start_step"] == 2
    np.testing.assert_allclose(got, mesh[0]["losses"][2:], rtol=0,
                               atol=TRAIN_LOSS_ATOL)
    # the mesh's final checkpoint against one device's steps 2-3 from the
    # same step-2 state: each of the two updates within ``TRAIN_PARAM_ATOL``
    # (its rule scaled to ``LAUNCH``'s lr), ``2 * lr`` each where the
    # final first moment, ``0.1 g`` a step, holds under ``TRAIN_TINY_GRAD``
    cfg = R.reduced_config(ARCH)
    like = TL.init_state(0, cfg, A.AdamWConfig(), device="cpu")
    one, step = CheckpointManager(ckpt).restore(like)
    two, step2 = CheckpointManager(root / "mesh22").restore(like)
    assert step == step2 == 4
    scale = LAUNCH["lr"] / TRAIN_OPT["lr"]
    for a, b, m in zip(ckpt_leaves(one[0]), ckpt_leaves(two[0]),
                       ckpt_leaves(one[1]["m"])):
        tiny = m.float().abs() / 0.1 < TRAIN_TINY_GRAD
        tol = torch.where(tiny, 2 * 2 * LAUNCH["lr"],
                          2 * TRAIN_PARAM_ATOL * scale)
        assert torch.all((a.float() - b.float()).abs() <= tol), \
            float((a.float() - b.float()).abs().max())


# the leaves JAX's ``param_pspecs`` cuts and the port holds whole: none
# (ZeRO-3's ``embed`` over ``data``, the vocabulary, SSD, RG-LRU and the
# query heads beside whole KV heads are all cut)
TRAIN_HELD_WHOLE = set()
# (arch, config change, ParallelConfig change): the train cases' configs
# and options, and configs whose vocabulary a model axis of 2 or 4
# divides (the reduced 257 is prime)
PLACEMENT_CASES = [
    (MOE, {}, {}), (MOE, {}, {"fsdp": False}), (MOE, {}, {"pure_dp": True}),
    ("yi-9b", {}, {}), ("yi-9b", {"num_kv_heads": 2}, {}), (ARCH, {}, {}),
    ("yi-9b", {"vocab_size": 256}, {}),
    ("mamba2-780m", {"vocab_size": 256}, {}),
    ("recurrentgemma-9b", {"vocab_size": 256}, {})]


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_training_placement_equals_jax_param_pspecs(shape):
    """The port's training placement (``placement_specs``) equals JAX's
    ``param_pspecs`` on every leaf and every axis, ``embed`` (ZeRO-3)
    included; no leaf JAX cuts is held whole (``TRAIN_HELD_WHOLE``).  The
    configs and options: ``PLACEMENT_CASES``."""
    from repro.models.layers import ParamDef

    mesh = make_test_mesh(shape)
    for arch, change, pchange in PLACEMENT_CASES:
        jcfg, tcfg = (dataclasses.replace(reg.reduced_config(arch), **change)
                      for reg in (JR, R))
        schema = JT.model_schema(jcfg)
        specs = JSH.param_pspecs(jcfg, mesh, **pchange)
        port = SH.placement_specs(SH.param_placement(
            tcfg, shape, device="cpu", **pchange))
        held = set()
        flat_defs = jax.tree_util.tree_flatten_with_path(
            schema, is_leaf=lambda x: isinstance(x, ParamDef))[0]
        flat_specs = jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert len(flat_defs) == len(port)
        for (path, d), spec in zip(flat_defs, flat_specs):
            key = "".join(f"['{p.key}']" for p in path)
            want = list(tuple(spec) + (None,) * (len(d.shape) - len(spec)))
            if port[key] == "whole":
                if any(want):
                    held.add("/".join(p.key for p in path[-2:]))
            else:
                assert port[key] == SH.spec_string(want), (arch, key)
        assert held == TRAIN_HELD_WHOLE, (arch, held)
