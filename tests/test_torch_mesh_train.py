"""Training's memory-only cuts on the port's ``(data, model)`` mesh against
the JAX package, on the CPU.

Every rank holds the cut JAX's ``param_pspecs`` gives on
``make_test_mesh``: ZeRO-3's ``embed`` axis over ``data``, the vocabulary,
SSD's inner width and heads, RG-LRU's width and the query heads beside
whole KV heads over ``model``.  One step of the port's ``make_train_step``
on each rank's cut (gloo ranks spawned by :func:`repro_torch.launch.mesh.
run_ranks`, the rank functions in ``tests/torch_mesh_jobs.py``) is held
to JAX's ``make_train_step`` jitted with ``make_pctx(make_test_mesh(
shape))``, with the tolerances of ``tests/test_torch_mesh.py``:

* yi-9b (``vocab_size=256``: the reduced vocabulary of 257 is prime) on
  ``(2, 2)``: ZeRO-3, the vocab-parallel embedding, unembedding and loss,
  and the query heads cut beside its one KV head;
* mamba2-780m (``vocab_size=256``) on ``(1, 4)``: SSD over ``model``, a
  tied vocabulary; and at ``d_model=48`` (6 heads), whose inner width
  ``model`` cuts but not its heads;
* recurrentgemma-9b (``vocab_size=256``) on ``(2, 2)``: RG-LRU over
  ``model``, local attention with one KV head, a tied vocabulary;
* the spiking GPT on ``(2, 2)`` with two microbatches and EF-int8
  gradient compression, and with one KV head on ``(1, 4)`` (its query
  heads cut beside it).

Besides: ZeRO-3's gathered weights are not kept from the forward to the
backward (the backward gathers them again), and the train launcher's
recurrentgemma-9b checkpoint, trained on ``(2, 2)`` under the cuts, is
read back on ``(1, 4)`` and on one device equal to the gathered whole.

The JAX steps compile in a pool of threads while the ranks run.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.base import ParallelConfig as JParallel
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as JT
from repro.models.layers import ParamDef
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro.parallel import sharding as JSH
from repro.train import loop as JL
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import map_with_placement
from repro_torch.configs import ParallelConfig
from repro_torch.configs import registry as R
from repro_torch.data.pipeline import DataConfig, MarkovStream
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.parallel import sharding as SH
from repro_torch.train import loop as TL

import torch_mesh_jobs as MJ

TIMEOUT_S = 240.0  # per spawn
ARCH = "xpikeformer-gpt-4-256"
V256 = {"vocab_size": 256}
# the tolerances of tests/test_torch_mesh.py (see there)
TRAIN_LOSS_ATOL = 1e-5
TRAIN_NORM_RTOL = 1e-5
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_PARAM_ATOL = 2e-2 * TRAIN_OPT["lr"]
TRAIN_TINY_GRAD = 1e-6
TRAIN_MOMENT_RTOL = 1e-4
# with EF-int8 compression a float32 gradient an ulp from JAX's may round
# to the next int8 step of its row: tests/test_torch_optim.py's rule for a
# stored value (at most STORAGE_FLIPS of a leaf's elements off, each
# within 2^-7 of the leaf's largest, the row step's bound)
STORAGE_FLIPS = 1e-3
CASES = {  # name: (arch, mesh shape, sequence, config change,
    #                 ParallelConfig change)
    "yi_vocab": ("yi-9b", (2, 2), 32, V256, {}),
    "mamba_ssd": ("mamba2-780m", (1, 4), 32, V256, {}),
    # 6 heads of 16: model=4 cuts the inner width, not the heads
    "mamba_inner": ("mamba2-780m", (1, 4), 32, dict(V256, d_model=48), {}),
    "rg_lru": ("recurrentgemma-9b", (2, 2), 32, V256, {}),
    "gpt_mb_ef": (ARCH, (2, 2), 32, {},
                  {"microbatches": 2, "grad_compression": True}),
    "gpt_kv1": (ARCH, (1, 4), 32, {"num_kv_heads": 1}, {}),
}
# the launcher's recurrentgemma-9b run on (2, 2) whose checkpoint the
# other meshes read
LAUNCH_ARCH = "recurrentgemma-9b"
LAUNCH = dict(smoke=True, steps=2, batch=8, seq_len=16, ckpt_every=0,
              fail_at=-1, straggler_factor=3.0, seed=0, log_every=0,
              lr=1e-3, probe=False)

_CASE = {}


def _case(name):
    """``(jcfg, tcfg, numpy params, tokens [8, S+1])``: the port's
    ``init_params(seed 0)`` and ``MarkovStream`` batch 0."""
    if name not in _CASE:
        arch, _, seq, change, _ = CASES[name]
        jcfg, tcfg = (dataclasses.replace(reg.reduced_config(arch), **change)
                      for reg in (JR, R))
        params = convert.params_to_numpy(T.init_params(tcfg, 0, "cpu"))
        tokens = MarkovStream(DataConfig(tcfg.vocab_size, seq, 8, seed=0),
                              device="cpu").batch_at(0)["tokens"].numpy()
        _CASE[name] = (jcfg, tcfg, params, tokens)
    return _CASE[name]


def _jax_step(name):
    """JAX's step (``remat="none"``, ``moe_impl="ep_a2a"``) jitted with
    ``make_pctx(make_test_mesh(shape))``, one step from fresh moments (and
    EF residuals) with key ``fold_in(PRNGKey(0), 0)``: numpy ``(params,
    opt_state, metrics)``."""
    jcfg, _, params, tokens = _case(name)
    _, shape, _, _, pchange = CASES[name]
    par = JParallel(remat="none", moe_impl="ep_a2a", **pchange)
    opt = JA.AdamWConfig(**TRAIN_OPT)
    jp = jax.tree.map(jnp.asarray, params)
    state = JA.init_opt_state(jp, opt)
    if par.grad_compression:
        state["ef"] = JC.init_ef_state(jp)
    step = jax.jit(JL.make_train_step(
        jcfg, JSH.make_pctx(make_test_mesh(shape), par), par, opt))
    out = step(jp, state, {"tokens": jnp.asarray(tokens)},
               jax.random.fold_in(jax.random.PRNGKey(0), 0))
    return jax.tree.map(np.asarray, out)


def _train_job(name):
    _, tcfg, params, tokens = _case(name)
    return dict(kind="train", cfg=tcfg, params=params, tokens=tokens,
                key_seed=0, opt=TRAIN_OPT, return_state=True,
                parallel=dict(remat="none", moe_impl="ep_a2a",
                              **CASES[name][4]))


@pytest.fixture(scope="module")
def refs():
    """JAX's steps, submitted to a pool of threads before the ranks
    spawn; ``{name: future}``."""
    for n in CASES:
        _case(n)
    pool = ThreadPoolExecutor(max_workers=os.cpu_count() or 4)
    yield {n: pool.submit(_jax_step, n) for n in CASES}
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def mesh22(refs, tmp_path_factory):
    """The (2, 2) spawn: its train cases, ZeRO-3's gathers over one loss
    of yi-9b, and the launcher's recurrentgemma-9b run;
    ``{name: [result per rank]}``."""
    ckpt = tmp_path_factory.mktemp("rg_launch")
    jcfg, tcfg, params, tokens = _case("yi_vocab")
    named = {f"train_{n}": _train_job(n) for n, c in CASES.items()
             if c[1] == (2, 2)}
    named["zero3"] = dict(kind="zero3", cfg=tcfg, params=params,
                          tokens=tokens, parallel=dict(remat="none"))
    named["launch"] = dict(kind="launch", arch=LAUNCH_ARCH,
                           kw=dict(LAUNCH, ckpt_dir=str(ckpt),
                                   restore=False))
    res = run_ranks(MJ.run_jobs, (2, 2), device="cpu",
                    args=(list(named.values()),), timeout_s=TIMEOUT_S)
    out = {name: [r[i] for r in res] for i, name in enumerate(named)}
    out["ckpt"] = str(ckpt)
    return out


@pytest.fixture(scope="module")
def mesh14(mesh22):
    """The (1, 4) spawn: its train cases, then the (2, 2) launcher's
    checkpoint read with each rank's placement."""
    cfg = R.reduced_config(LAUNCH_ARCH)
    named = {f"train_{n}": _train_job(n) for n, c in CASES.items()
             if c[1] == (1, 4)}
    named["restore"] = dict(kind="restore", cfg=cfg, ckpt=mesh22["ckpt"],
                            parallel=dict(remat="none"))
    res = run_ranks(MJ.run_jobs, (1, 4), device="cpu",
                    args=(list(named.values()),), timeout_s=TIMEOUT_S)
    return {name: [r[i] for r in res] for i, name in enumerate(named)}


def _blocks(tree, place):
    return map_with_placement(
        lambda x, where, field: x if where.whole else where.piece(x, field),
        tree, place)


def _cut_close(got, want, place, what, *, atol=None, rtol_of_max=None,
               grads=None, flips=0.0):
    """Each leaf of a rank's ``got`` against its block of ``want``: within
    ``atol``, or ``rtol_of_max`` of the leaf's largest entry; with
    ``grads`` (JAX's first moments, ``0.1 g``) within ``2 * lr`` where
    ``|g|`` is below ``TRAIN_TINY_GRAD`` (tests/test_torch_mesh.py);
    ``flips``: that share of the elements may be off by one storage step
    instead (``STORAGE_FLIPS``)."""
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
        off = np.abs(g - w) > tol
        step = 2.0 ** -7 * float(np.max(np.abs(w), initial=0.0))
        assert np.mean(off) <= flips and np.all(
            np.abs(g - w)[off] <= step), \
            f"{what}{path}: {float(np.max(np.abs(g - w)))}"

    walk(got, block, gblock, what)


def _jax_specs(jcfg, shape):
    """``{path: spec string}`` of JAX's ``param_pspecs`` on
    ``make_test_mesh(shape)``, every axis kept, in the port's path form."""
    schema = JT.model_schema(jcfg)
    specs = JSH.param_pspecs(jcfg, make_test_mesh(shape))
    defs = jax.tree_util.tree_flatten_with_path(
        schema, is_leaf=lambda x: isinstance(x, ParamDef))[0]
    flat = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for (path, d), spec in zip(defs, flat):
        key = "".join(f"['{p.key}']" for p in path)
        full = list(tuple(spec) + (None,) * (len(d.shape) - len(spec)))
        out[key] = SH.spec_string(full) if any(full) else "whole"
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_cut_placement_equals_jax_param_pspecs(name):
    """Every rank's placement (``placement_specs``) equals JAX's
    ``param_pspecs`` on every leaf and every axis, ``embed`` included;
    each rank's pieces tile the whole leaf."""
    jcfg, tcfg, params, _ = _case(name)
    _, shape, _, _, pchange = CASES[name]
    want = _jax_specs(jcfg, shape)
    for rank in range(shape[0] * shape[1]):
        place = SH.param_placement(tcfg, shape, device="cpu",
                                   data_index=rank // shape[1],
                                   model_index=rank % shape[1], **{
                                       k: v for k, v in pchange.items()
                                       if k in ("fsdp", "pure_dp")})
        assert SH.placement_specs(place) == want, (name, rank)
    held = sum(np.asarray(x).size for x in jax.tree.leaves(_blocks(
        params, SH.param_placement(tcfg, shape, device="cpu"))))
    whole = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert held < whole


@pytest.mark.parametrize("name", list(CASES))
def test_cut_train_step_equals_jax(refs, mesh22, mesh14, name):
    """One step on each rank's cut == the matching block of JAX's step on
    ``make_test_mesh``: the updated leaves (``TRAIN_PARAM_ATOL``), the
    AdamW moments (``TRAIN_MOMENT_RTOL``), the loss and the metrics JAX
    reports (``TRAIN_LOSS_ATOL``; with microbatches JAX reports no
    ``xent``) and the gradient norm (``TRAIN_NORM_RTOL``); under
    compression a moment may flip one int8 step in ``STORAGE_FLIPS`` of a
    leaf's elements."""
    _, shape, _, _, pchange = CASES[name]
    flips = STORAGE_FLIPS if pchange.get("grad_compression") else 0.0
    jp, js, jm = refs[name].result()
    _, tcfg, _, _ = _case(name)
    res = (mesh22 if shape == (2, 2) else mesh14)[f"train_{name}"]
    assert len(res) == shape[0] * shape[1]
    for rank, r in enumerate(res):
        m = r["metrics"][0]
        for k in ("loss", "xent", "moe_aux"):
            if k in jm:
                assert abs(m[k] - float(jm[k])) <= TRAIN_LOSS_ATOL, (rank, k)
        np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]),
                                   rtol=TRAIN_NORM_RTOL)
        place = SH.param_placement(tcfg, shape, device="cpu",
                                   data_index=rank // shape[1],
                                   model_index=rank % shape[1])
        _cut_close(r["params"], jp, place, f"rank {rank} params",
                   atol=TRAIN_PARAM_ATOL, grads=js["m"])
        for mom in ("m", "v"):
            _cut_close(r[mom], js[mom], place, f"rank {rank} {mom}",
                       rtol_of_max=TRAIN_MOMENT_RTOL, flips=flips)


def test_zero3_gathers_are_not_kept_for_the_backward(mesh22):
    """yi-9b's loss on (2, 2): every ``embed``-cut leaf is gathered over
    ``data`` in the forward (its 2 layers' 9 leaves, the table, the final
    norm and the unembedding), none of the gathered tensors is alive when
    the forward ends, and the backward gathers again what it reads (at
    least every block leaf)."""
    for r in mesh22["zero3"]:
        assert r["gathers"] == 2 * 9 + 3, r
        assert r["live"] == 0, r
        assert r["regathers"] >= 2 * 9, r


def test_cut_checkpoint_restores_across_meshes(mesh22, mesh14):
    """The launcher's recurrentgemma-9b run on (2, 2) (ZeRO-3, RG-LRU and
    the query heads cut): its losses are finite and equal on every rank,
    and its checkpoint (gathered whole, a leaf at a time) read on (1, 4)
    gives each rank exactly its block of the whole, as one device reads
    it."""
    losses = [r["losses"] for r in mesh22["launch"]]
    assert len(losses[0]) == LAUNCH["steps"]
    assert all(np.isfinite(losses[0])) and all(x == losses[0]
                                               for x in losses)
    cfg = R.reduced_config(LAUNCH_ARCH)
    opt = A.AdamWConfig()
    (params, state), step = CheckpointManager(mesh22["ckpt"]).restore(
        TL.init_state(0, cfg, opt, device="cpu"))
    assert step == LAUNCH["steps"]
    whole = {"params": convert.params_to_numpy(params),
             "m": convert.params_to_numpy(state["m"]),
             "v": convert.params_to_numpy(state["v"])}
    for rank, r in enumerate(mesh14["restore"]):
        assert r["step"] == step
        place = SH.param_placement(cfg, (1, 4), device="cpu",
                                   model_index=rank)
        assert any(not p.whole for p in SH.leaf_placements(params, place))
        for k in ("params", "m", "v"):
            got = jax.tree.leaves(r[k])
            want = jax.tree.leaves(_blocks(whole[k], place))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_train_step_on_a_mesh_takes_microbatches_and_compression():
    """``microbatches > 1`` and ``grad_compression`` on a cut state no
    longer raise when the step is built (the values: the ``gpt_mb_ef``
    case)."""
    from repro_torch.launch.mesh import ServingMesh

    cfg = R.reduced_config(ARCH)
    par = ParallelConfig(microbatches=2, grad_compression=True)
    mesh = ServingMesh((2, 2), 0, torch.device("cpu"))
    assert callable(TL.make_train_step(cfg, par, mesh=mesh))
