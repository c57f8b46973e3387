"""Mixture-of-Experts in the port against the JAX package, on the CPU.

* ``models/moe.py`` on a small config (``d=16``, 4 experts of ``d_ff=32``,
  top 2, float32), weights and inputs from a numpy seed: the router's
  weights and auxiliary loss (its choices where the top-2 margin exceeds
  ``TIE_MARGIN``), ``moe_dense``, the single-device ``moe_ep`` given
  JAX's router outputs, and its capacity drops at ``capacity_factor=0.1``
  (the same rows zeroed as in JAX);
* the reduced ``arctic-480b`` (a dense residual MLP beside the experts)
  and ``phi3.5-moe-42b-a6.6b``, with the port's weights carried to JAX
  through numpy: ``init_params`` draws JAX's, the forward's logits and
  ``moe_aux`` under ``moe_impl="dense"`` and ``"ep_a2a"``, the loss and
  every gradient leaf (``GRADS``), teacher-forced decode under both
  against JAX's ``decode_step``, ``BatchScheduler``'s streams against JAX's, and the
  train launcher for 4 steps;
* a spiking SSA MoE (the reduced phi3.5-moe with ``spiking=True``): the
  forward's logits and twelve decode steps against JAX's
  ``IntegerBackend`` (the FFN on the rate interface);
* a training mesh the expert-parallel dispatch cannot take raises
  (``tests/test_torch_mesh.py`` trains, serves and forwards MoE on the
  mesh).

The JAX references compile once, in a pool of threads (``refs``).
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
from repro.configs.base import ModelConfig as JModelConfig
from repro.engine import IntegerBackend as JIntegerBackend
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.moe import ParallelCtx
from repro.serving import BatchScheduler as JBatchScheduler
from repro_torch import convert
from repro_torch.configs import ModelConfig
from repro_torch.configs import ParallelConfig
from repro_torch.configs import registry as R
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import Executor
from repro_torch.engine import XpikeformerEngine, get_backend
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as LT
from repro_torch.launch.mesh import ServingMesh
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serving import BatchScheduler
from repro_torch.train import loop as TL

# float32 outputs of order one: the expert einsums and silu's exp round
# in other orders than XLA's
ATOL = 1e-5
# the router's top-k compared where the k-th and (k+1)-th probabilities
# are further apart than this (softmax's exp is a float boundary)
TIE_MARGIN = 1e-6
# a gradient leaf, against its largest value: sums of the backward in
# other orders
GRAD_RTOL = 1e-4
# erfinv: torch's and XLA's differ in the last bits of a normal draw
INIT_ATOL = 2e-5
# the spiking stack's logits (tests/test_torch_lm_forward.py's ATOL):
# the rate coding's sigmoid, layernorm and the unembed
SPIKE_ATOL = 1e-4

MOE_ARCHS = ("arctic-480b", "phi3.5-moe-42b-a6.6b")
IMPLS = ("dense", "ep_a2a")
FWD_SHAPE, GRAD_SHAPE, DECODE_SHAPE = (2, 16), (2, 13), (3, 12)
# each config under one impl (a gradient takes JAX 3-4 s to compile)
GRADS = (("arctic-480b", "ep_a2a"), ("phi3.5-moe-42b-a6.6b", "dense"))
SPIKING = "phi3.5-moe-spiking"
SERVE_PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9], [10, 11, 12, 13],
                 [5, 5, 5, 5, 5, 5, 5]]


@pytest.fixture(autouse=True)
def one_thread():
    """Torch's CPU ops on one thread: the decode and serving cases run
    many small ops, whose thread teams would wait on threads the other
    test workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# models/moe.py on a small config
# ---------------------------------------------------------------------------


def _unit_cfgs(cf: float):
    j = JModelConfig(name="t", family="moe", num_layers=1, d_model=16,
                     num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=64,
                     num_experts=4, moe_top_k=2, capacity_factor=cf,
                     dtype="float32")
    return j, ModelConfig(**dataclasses.asdict(j))


def _unit_params():
    """numpy weights ``normal / sqrt(fan)`` of the MoE schema."""
    rng = np.random.default_rng(0)
    out = {}
    for name, (shape, _) in M.moe_schema(_unit_cfgs(1.0)[1]).items():
        fan = shape[-2]
        out[name] = (rng.standard_normal(shape) / np.sqrt(fan)).astype(
            np.float32)
    return out


def _unit_x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


UNIT_X, DROP_X = (2, 8, 16), (1, 64, 16)


def _tp(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# The stacks: the port's weights carried to JAX
# ---------------------------------------------------------------------------


def _cfgs(arch):
    if arch == SPIKING:
        change = dict(spiking=True, attention_kind="ssa", spike_T=4)
        return tuple(dataclasses.replace(
            reg.reduced_config("phi3.5-moe-42b-a6.6b"), **change)
            for reg in (JR, R))
    return JR.reduced_config(arch), R.reduced_config(arch)


_SETUP = {}


def _setup(arch):
    """``(jcfg, tcfg, JAX params, the port's)``, once per arch: the port's
    ``init_params(seed 0)`` carried to JAX through numpy."""
    if arch not in _SETUP:
        jcfg, tcfg = _cfgs(arch)
        tp = T.init_params(tcfg, 0, "cpu")
        jp = jax.tree.map(jnp.asarray, convert.params_to_numpy(tp))
        _SETUP[arch] = (jcfg, tcfg, jp, tp)
    return _SETUP[arch]


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 257, (b, s)).astype(
        np.int32)


def _leaves(tree):
    """A tree's leaves in ``jax.tree``'s order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _zero_cache(jcfg, b, s):
    """JAX's ``init_cache`` as numpy zeros (no eager JAX op a leaf)."""
    return jax.tree.map(lambda x: np.zeros(x.shape, x.dtype),
                        JT.cache_schema(jcfg, b, s))


def _jax_serve(arch):
    """JAX's ``BatchScheduler`` (its default ``moe_impl``, ``"ep_a2a"``):
    five requests through 3 slots, 5 new tokens each -> (streams,
    ``energy_j``)."""
    jcfg, _, jp, _ = _setup(arch)
    sch = JBatchScheduler(jp, jcfg, slots=3, cache_len=24)
    rids = [sch.submit(p, 5, seed=i) for i, p in enumerate(SERVE_PROMPTS)]
    out = sch.run()
    return [out[r] for r in rids], sch.stats.energy_j


SPIKE_SEEDS = np.arange(2, dtype=np.uint32)


def _reference_jobs():
    """``{name: (function, arguments)}``: every JAX computation the tests
    hold the port to."""
    jobs = {}
    for cf, x in ((1.0, UNIT_X), (0.1, DROP_X)):
        jcfg, _ = _unit_cfgs(cf)
        args = (_unit_params(), _unit_x(x, len(x)))
        jobs["router", cf] = (lambda p, x, c=jcfg: JM.router(p, x, c), args)
        jobs["ep", cf] = (lambda p, x, c=jcfg: JM.moe_ep(
            p, x, c, ParallelCtx(), seq_sharded=False), args)
    jcfg, _ = _unit_cfgs(1.0)
    jobs["dense"] = (lambda p, x, c=jcfg: JM.moe_dense(p, x, c),
                     (_unit_params(), _unit_x(UNIT_X, 3)))
    for arch in MOE_ARCHS:
        jcfg, _, jp, _ = _setup(arch)
        for impl in IMPLS:
            jobs["forward", arch, impl] = (
                lambda p, x, c=jcfg, i=impl: JT.forward(
                    p, {"tokens": x}, c, moe_impl=i, remat="none"),
                (jp, _tokens(*FWD_SHAPE, 1)))
            if (arch, impl) in GRADS:
                jobs["grad", arch, impl] = (jax.value_and_grad(
                    lambda p, t, c=jcfg, i=impl: JT.loss_fn(
                        p, {"tokens": t}, c, moe_impl=i, remat="none"),
                    has_aux=True), (jp, _tokens(*GRAD_SHAPE, 2)))
            b, s = DECODE_SHAPE
            jobs["decode", arch, impl] = (
                lambda p, cache, t, c=jcfg, i=impl: JT.decode_step(
                    p, cache, t, c, moe_impl=i),
                (jp, _zero_cache(jcfg, b, s), _tokens(b, 1, 3)))
    jcfg, _ = _cfgs("arctic-480b")
    jobs["init"] = (lambda k, c=jcfg: JT.init_params(k, c),
                    (jax.random.PRNGKey(0),))
    jcfg, _, jp, _ = _setup(SPIKING)
    jobs["forward", SPIKING] = (
        lambda p, x, k, c=jcfg: JT.forward(
            p, {"tokens": x}, c, rng=k, backend=JIntegerBackend()),
        (jp, _tokens(2, 12, 5), jax.random.PRNGKey(3)))
    jobs["decode", SPIKING] = (
        lambda p, cache, t, c=jcfg: JT.decode_step(
            p, cache, t, c, backend=JIntegerBackend(), seeds=SPIKE_SEEDS),
        (jp, JT.init_cache(jcfg, 2, 12), _tokens(2, 1, 5)))
    return jobs


def _compile(fn, args):
    return jax.jit(fn).lower(*args).compile()


@pytest.fixture(scope="module")
def refs():
    """The JAX computations, lowered and compiled in a pool of threads
    (XLA compiles in parallel); JAX's serves run in the same pool."""
    jobs = _reference_jobs()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex:
        # the longest compiles first (the gradients), then the serves,
        # whose steps compile as they go
        futures = {k: ex.submit(_compile, *jobs.pop(k))
                   for k in [("grad",) + g for g in GRADS]}
        futures.update({("serve", a): ex.submit(_jax_serve, a)
                        for a in MOE_ARCHS})
        futures.update({k: ex.submit(_compile, fn, args)
                        for k, (fn, args) in jobs.items()})
        return {k: f.result() for k, f in futures.items()}


# ---------------------------------------------------------------------------
# models/moe.py
# ---------------------------------------------------------------------------


def test_router(refs):
    """Weights and aux within ``ATOL``; the choices equal where the top-2
    margin exceeds ``TIE_MARGIN`` (all of them at this seed)."""
    _, tcfg = _unit_cfgs(1.0)
    x = _unit_x(UNIT_X, len(UNIT_X))
    jw, jidx, jaux = refs["router", 1.0](_unit_params(), x)
    tw, tidx, taux = M.router(_tp(_unit_params()), torch.from_numpy(x), tcfg)
    _close(tw, jw)
    _close(taux, jaux)
    logits = (x @ _unit_params()["router"]).astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = np.sort(probs / probs.sum(-1, keepdims=True), axis=-1)[..., ::-1]
    clear = probs[..., 1] - probs[..., 2] > TIE_MARGIN
    assert clear.all()
    np.testing.assert_array_equal(tidx.numpy()[clear], np.asarray(jidx)[clear])
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_router_breaks_ties_to_the_lower_expert():
    """Equal probabilities: the lower expert first, as ``lax.top_k``."""
    _, tcfg = _unit_cfgs(1.0)
    p = {"router": torch.zeros((16, 4))}
    _, idx, aux = M.router(p, torch.ones((1, 3, 16)), tcfg)
    assert idx.tolist() == [[[0, 1]] * 3]
    assert float(aux) == pytest.approx(2.0)  # E * sum(1/E * choices) = k


def test_moe_dense(refs):
    _, tcfg = _unit_cfgs(1.0)
    x = _unit_x(UNIT_X, 3)
    jy, jaux = refs["dense"](_unit_params(), x)
    ty, taux = M.moe_dense(_tp(_unit_params()), torch.from_numpy(x), tcfg)
    _close(ty, jy)
    _close(taux, jaux)


@pytest.mark.parametrize("cf", [1.0, 0.1])
def test_moe_ep_given_jax_routing(refs, cf):
    """The single-device sort-based dispatch given JAX's router outputs:
    within ``ATOL`` of JAX's ``moe_ep`` (the combine's k additions from
    zero are order-free); at ``capacity_factor=0.1`` the same rows are
    dropped (zero) as in JAX, and some are."""
    _, tcfg = _unit_cfgs(cf)
    shape = UNIT_X if cf == 1.0 else DROP_X
    x = _unit_x(shape, len(shape))
    jw, jidx, _ = refs["router", cf](_unit_params(), x)
    jy, _ = refs["ep", cf](_unit_params(), x)
    b, s, d = shape
    ty = M._ep_local(torch.from_numpy(x).reshape(b * s, d),
                     torch.from_numpy(np.array(jw)).reshape(b * s, -1),
                     torch.from_numpy(np.array(jidx)).long().reshape(
                         b * s, -1), _tp(_unit_params()), tcfg)
    _close(ty.reshape(shape), jy)
    zero_t = (ty == 0).all(-1).numpy()
    zero_j = np.all(np.asarray(jy).reshape(b * s, d) == 0, axis=-1)
    np.testing.assert_array_equal(zero_t, zero_j)
    assert zero_t.any() == (cf < 1.0)
    # and through the port's own router, the whole moe_ep
    got, _ = M.moe_ep(_tp(_unit_params()), torch.from_numpy(x), tcfg)
    _close(got, jy)


def test_moe_ep_equals_dense_without_drops():
    """At ``capacity_factor=16`` no choice drops: ``ep_a2a`` is
    ``moe_dense`` (the reference's own check), and both are
    differentiable."""
    _, tcfg = _unit_cfgs(16.0)
    p = {k: v.requires_grad_(True) for k, v in _tp(_unit_params()).items()}
    x = torch.from_numpy(_unit_x(UNIT_X, 9))
    ye, ae = M.moe_apply(p, x, tcfg, impl="ep_a2a")
    yd, ad = M.moe_apply(p, x, tcfg, impl="dense")
    np.testing.assert_allclose(ye.detach().numpy(), yd.detach().numpy(),
                               rtol=0, atol=1e-6)
    assert float(ae.detach()) == float(ad.detach())
    grads = torch.autograd.grad((ye ** 2).sum() + 0.01 * ae,
                                [p["wi"], p["wo"], p["router"]])
    assert all(float(g.abs().sum()) > 0 for g in grads)
    with pytest.raises(ValueError, match="moe_impl"):
        M.moe_apply(p, x, tcfg, impl="megablocks")


# ---------------------------------------------------------------------------
# The MoE stacks
# ---------------------------------------------------------------------------


def test_init_params_draw_the_references(refs):
    """arctic's reduced tree (router, experts, the dense residual MLP)
    equals JAX's ``init_params(PRNGKey(0))`` leaf for leaf."""
    _, tcfg = _cfgs("arctic-480b")
    want = jax.tree.leaves(refs["init"](jax.random.PRNGKey(0)))
    got = _leaves(T.init_params(tcfg, 0, "cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, INIT_ATOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_logits_and_aux(refs, arch, impl):
    _, tcfg, jp, tp = _setup(arch)
    tokens = _tokens(*FWD_SHAPE, 1)
    jl, jaux = refs["forward", arch, impl](jp, tokens)
    with torch.no_grad():
        tl, taux = T.forward(tp, {"tokens": torch.from_numpy(tokens).long()},
                             tcfg, moe_impl=impl, remat="none")
    _close(tl, jl)
    _close(taux, jaux)
    assert float(taux) > 0


@pytest.mark.parametrize("arch,impl", GRADS)
def test_loss_and_gradients(refs, arch, impl):
    """The loss, its cross-entropy and ``moe_aux``, and every gradient
    leaf (the router's and the experts' included) against
    ``jax.value_and_grad``."""
    _, tcfg, jp, tp = _setup(arch)
    tokens = _tokens(*GRAD_SHAPE, 2)
    (jl, jaux), jg = refs["grad", arch, impl](jp, tokens)
    (tl, taux), tg = TL.value_and_grad(
        lambda p, b: T.loss_fn(p, b, tcfg, moe_impl=impl, remat="none"))(
            tp, {"tokens": torch.from_numpy(tokens).long()})
    _close(tl, jl)
    for k in ("xent", "moe_aux"):
        _close(taux[k], jaux[k])
    got, want = _leaves(tg), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, GRAD_RTOL * max(float(np.max(np.abs(w))), 1e-6))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_reference(refs, arch, impl):
    """Twelve teacher-forced decode steps of 3 slots against JAX's
    ``decode_step`` under the same ``moe_impl``; under ``"dense"`` the
    decode also matches the port's forward within the reference's
    5e-3 (``ep_a2a``'s capacities depend on the tokens routed
    together)."""
    jcfg, tcfg, jp, tp = _setup(arch)
    b, s = DECODE_SHAPE
    tokens = _tokens(b, s, 3)
    jcache = _zero_cache(jcfg, b, s)
    tcache = T.init_cache(tcfg, b, s, "cpu")
    outs = []
    with torch.no_grad():
        for i in range(s):
            want, jcache = refs["decode", arch, impl](jp, jcache,
                                                      tokens[:, i:i + 1])
            got, tcache = T.decode_step(tp, tcache, torch.from_numpy(
                tokens[:, i:i + 1]).long(), tcfg, moe_impl=impl)
            _close(got, want, what=f"step {i}")
            outs.append(got)
        if impl == "dense":
            full, _ = T.forward(tp, {"tokens": torch.from_numpy(tokens)
                                     .long()}, tcfg, moe_impl="dense")
            _close(torch.cat(outs, 1), full.numpy(), 5e-3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_batch_scheduler_matches_reference(refs, arch):
    """Five requests through 3 slots, ``moe_impl`` resolved as JAX's
    (``"ep_a2a"``): the greedy streams equal JAX's, no joules booked."""
    _, tcfg, _, tp = _setup(arch)
    want, energy = refs["serve", arch]
    sch = BatchScheduler(tp, tcfg, slots=3, cache_len=24, device="cpu")
    assert sch.moe_impl == "ep_a2a" and sch.plan is None
    rids = [sch.submit(p, 5, seed=i) for i, p in enumerate(SERVE_PROMPTS)]
    out = sch.run()
    assert [out[r] for r in rids] == want
    assert sch.stats.energy_j == energy == 0.0


def test_engine_and_serve_cli(refs, capsys):
    """The engine's scheduler is cached per ``moe_impl`` and serves the
    scheduler's streams; the serve CLI serves the reduced phi3.5-moe."""
    _, tcfg, _, tp = _setup("phi3.5-moe-42b-a6.6b")
    eng = XpikeformerEngine.from_config("phi3.5-moe-42b-a6.6b", task="lm",
                                        reduced=True, device="cpu")
    eng.params = tp
    prompts = SERVE_PROMPTS[:2]
    with torch.no_grad():
        dense = eng.generate(prompts, 4, cache_len=16, moe_impl="dense")
        ep = eng.generate(prompts, 4, cache_len=16)
    assert len(eng._schedulers) == 2
    sch = BatchScheduler(tp, tcfg, slots=4, cache_len=16, device="cpu",
                         moe_impl="dense")
    rids = [sch.submit(p, 4, seed=i) for i, p in enumerate(prompts)]
    outs = sch.run()
    assert dense == [outs[r] for r in rids]
    assert all(len(o) == 4 for o in ep)
    serve_cli.main(["--arch", "phi3.5-moe-42b-a6.6b", "--requests", "2",
                    "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "the float decode path" in out and "served 2 requests" in out


class _Stream:
    """A stand-in for ``MarkovStream`` (its ``257**3`` table takes seconds
    to draw on one thread): ``batch_at(step)``, uniform tokens from ``seed
    + step``."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg, self.device = cfg, device

    def batch_at(self, step: int):
        rng = np.random.default_rng(self.cfg.seed + step)
        c = self.cfg
        tok = rng.integers(0, c.vocab_size, (c.global_batch, c.seq_len + 1))
        return {"tokens": torch.from_numpy(tok).to(self.device)}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_launcher(tmp_path, monkeypatch, arch):
    """``launch.train.run`` for 4 steps (``moe_impl="ep_a2a"``): every
    loss finite, and the loss moves (the reference's
    ``test_launcher_moe_arch`` bound); the probe batch's loss falls."""
    monkeypatch.setattr(LT, "MarkovStream", _Stream)
    losses, before, after = LT.run(arch, steps=4, batch=2, seq_len=12,
                                   ckpt_dir=str(tmp_path), log_every=0,
                                   device="cpu", probe=True)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] != losses[0] and losses[-1] < losses[0] * 1.2
    assert after < before


# ---------------------------------------------------------------------------
# The spiking MoE
# ---------------------------------------------------------------------------


def test_spiking_moe_forward_and_decode(refs):
    """A spiking SSA stack with MoE FFNs (on the rate interface, dense, as
    the reference runs them): the forward's logits and twelve decode
    steps' against JAX's on its ``IntegerBackend`` within ``SPIKE_ATOL``;
    the forward's ``aux`` is JAX's; the scheduler's plan is unfused."""
    jcfg, tcfg, jp, tp = _setup(SPIKING)
    tokens = _tokens(2, 12, 5)
    want, jaux = refs["forward", SPIKING](jp, tokens, jax.random.PRNGKey(3))
    key = torch.from_numpy(np.asarray(jax.random.PRNGKey(3)).astype(np.int64))
    with torch.no_grad():
        got, aux = T.forward(tp, {"tokens": torch.from_numpy(tokens).long()},
                             tcfg, rng=key, backend="integer")
    _close(got, want, SPIKE_ATOL)
    _close(aux, jaux)
    jcache = JT.init_cache(jcfg, 2, 12)
    tcache = T.init_cache(tcfg, 2, 12, "cpu")
    seeds = torch.from_numpy(SPIKE_SEEDS.astype(np.int64))
    with torch.no_grad():
        for i in range(12):
            want, jcache = refs["decode", SPIKING](jp, jcache,
                                                   tokens[:, i:i + 1])
            got, tcache = T.decode_step(
                tp, tcache, torch.from_numpy(tokens[:, i:i + 1]).long(),
                tcfg, backend=get_backend("integer"), seeds=seeds)
            _close(got, want, SPIKE_ATOL, f"step {i}")
    sch = BatchScheduler(tp, tcfg, get_backend("integer"), device="cpu")
    assert sch.plan is not None and not sch.plan.fused


# ---------------------------------------------------------------------------
# The mesh boundary
# ---------------------------------------------------------------------------


def test_moe_on_a_mesh_raises(tmp_path):
    """Training a MoE config on a mesh places it (``tests/
    test_torch_mesh.py`` trains it against JAX); what raises is a
    training mesh the reference's expert-parallel dispatch cannot take:
    experts that ``model`` does not divide, and a model axis without the
    sequence split (the reference's senders would route the same tokens,
    ROADMAP queue C), and ``moe_impl="dense"`` on a rank's block of the
    experts.  Serving builds: the executor for the float MoE (its
    experts cut in blocks of ``E / model``) and for the spiking one (its
    experts whole, their FFN on the rate interface)."""
    _, tcfg, _, tp = _setup("phi3.5-moe-42b-a6.6b")
    _, scfg, _, sp = _setup(SPIKING)
    mesh = ServingMesh((2, 1), 0, torch.device("cpu"))
    assert callable(TL.make_train_step(tcfg, ParallelConfig(), mesh=mesh))
    with pytest.raises(ValueError, match="do not split"):
        TL.make_train_step(tcfg, ParallelConfig(), mesh=ServingMesh(
            (1, 3), 0, torch.device("cpu")))
    pctx = M.ParallelCtx(mesh=ServingMesh((1, 2), 0, torch.device("cpu")),
                         train=True, seq_shard=False)
    x = torch.zeros((2, 4, tcfg.d_model))
    with pytest.raises(NotImplementedError, match="sequence split"):
        M.moe_ep(tp["periods"]["blk0"]["moe"], x, tcfg, pctx)
    block = {k: v[:, 2:] for k, v in tp["periods"]["blk0"]["moe"].items()
             if k != "router"}
    with pytest.raises(NotImplementedError, match="moe_impl='ep_a2a'"):
        M.moe_dense(block, x, tcfg, pctx)
    split = ServingMesh((1, 2), 1, torch.device("cpu"))
    ex = Executor(tp, tcfg, "integer", split)
    wi = tp["periods"]["blk0"]["moe"]["wi"]
    assert torch.equal(ex.params["periods"]["blk0"]["moe"]["wi"], wi[:, 2:])
    ex = Executor(sp, scfg, "integer", split)
    assert ex.params["periods"]["blk0"]["moe"]["wi"] is \
        sp["periods"]["blk0"]["moe"]["wi"]
