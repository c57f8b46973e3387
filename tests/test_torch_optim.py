"""The port's optimizer, train step and data pipeline against the JAX
package, on the CPU.

* AdamW in float32, bfloat16 and int8 state, three steps from one state
  (``convert.opt_state_from_numpy``) against the reference's jitted
  ``apply_updates``.  The port computes as XLA does in the jitted step on
  the CPU (each ``a * b + c`` one fused multiply-add, divisions by a
  constant products with the reciprocal); what is left is the order of
  the global norm's sum, the ``cos`` of the schedule and ``pow``.  So the
  learning rate and every float32 number agree within ``ULP_RTOL`` (a
  parameter within that of the learning rate: near zero ``p - lr delta``
  cancels), and a stored moment (int8 ``q``, bfloat16) is equal but for
  one unit in at most ``STORAGE_FLIPS`` of its elements (whose parameters
  then move by that unit of the learning rate);
* the schedules and the clip; the EF-int8 round trip bit for bit;
* ``make_train_step`` on the reduced LM config with two microbatches, EF
  compression and int8 state: the loss within ``LOSS_ATOL``, the updated
  parameters within ``PARAM_ATOL`` (a step moves a weight by about the
  learning rate: a gradient of the other sign near zero is the only way to
  differ by more than an ulp);
* ``MarkovStream``: its uniforms and initial tokens are JAX's bit for bit;
  given JAX's Gumbel noise (two ``log``s: a float boundary) its chain
  gives JAX's tokens, and so does its own noise here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.base import ParallelConfig as JParallel
from repro.data import pipeline as JDP
from repro.models.moe import ParallelCtx
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro.train import loop as JL
from repro_torch import convert, prng
from repro_torch import tree as TR
from repro_torch.configs import ParallelConfig
from repro_torch.configs import registry as R
from repro_torch.data.pipeline import DataConfig, MarkovStream
from repro_torch.optim import adamw as A
from repro_torch.optim import compression as C
from repro_torch.train import loop as L

ULP_RTOL = 5e-7
LOSS_ATOL = 1e-5
LR = 1e-3
PARAM_ATOL = 2e-2 * LR
STORAGE_FLIPS = 1e-3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def _tree(rng):
    return {"a": rng.normal(size=(64, 96)).astype(np.float32),
            "stack": [rng.normal(size=(2, 48, 128)).astype(np.float32)],
            "b": rng.normal(size=(96,)).astype(np.float32),
            "small": rng.normal(size=(16, 16)).astype(np.float32)}


def _is_q(x):
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _close_trees(got, want, what, rtol=ULP_RTOL, atol=0.0):
    """Walk the port's tree and the reference's by key (JAX orders a
    dict's leaves by key, the port by insertion).  A stored moment (int8
    ``q``, a bfloat16 leaf) may differ by one unit of its storage in at
    most ``STORAGE_FLIPS`` of its elements: a float32 value an ulp apart
    rounds across a storage boundary there."""
    if _is_q(got):
        d = np.abs(got["q"].numpy().astype(int) - np.asarray(want["q"]))
        assert d.max() <= 1 and np.mean(d > 0) <= STORAGE_FLIPS, \
            f"{what} int8 q: {int((d > 0).sum())} differ"
        got, want = got["scale"], want["scale"]
    if isinstance(got, dict):
        assert set(got) == set(want), what
        for k in got:
            _close_trees(got[k], want[k], f"{what}/{k}", rtol, atol)
    elif isinstance(got, list):
        for i, (g, w) in enumerate(zip(got, want)):
            _close_trees(g, w, f"{what}/{i}", rtol, atol)
    elif got.dtype == torch.bfloat16:
        g, w = _np(got), _np(want)
        off = ~np.isclose(g, w, rtol=rtol, atol=atol)
        assert np.mean(off) <= STORAGE_FLIPS, f"{what}: {int(off.sum())} off"
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=atol,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                                   err_msg=what)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("schedule,clip", [("cosine", 1.0), ("linear", 0.05),
                                           ("constant", 0.0)])
def test_adamw_equals_jax(state_dtype, schedule, clip):
    rng = np.random.default_rng(7)
    params = _tree(rng)
    kw = dict(lr=1e-2, state_dtype=state_dtype, warmup_steps=2,
              total_steps=6, schedule=schedule, grad_clip=clip)
    jcfg, tcfg = JA.AdamWConfig(**kw), A.AdamWConfig(**kw)
    jp, js = params, JA.init_opt_state(params, jcfg)
    tp = convert.params_from_numpy(params, device="cpu")
    ts = convert.opt_state_from_numpy(jax.tree.map(np.asarray, js),
                                      device="cpu")
    _close_trees(ts["m"], js["m"], "init m")
    f = jax.jit(lambda p, g, s: JA.apply_updates(p, g, s, jcfg))
    for step in range(3):
        g = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 3e-3).astype(
            np.float32), params)
        jp, js, jm = f(jp, g, js)
        tp, ts, tm = A.apply_updates(
            tp, convert.params_from_numpy(g, device="cpu"), ts, tcfg)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=ULP_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        # a step moves a weight by lr * delta: an ulp of delta is lr ulps;
        # a stored moment one unit apart moves delta by that unit
        unit = 5e-7 if state_dtype == "float32" else 2.0 ** -6
        _close_trees(tp, jp, f"params step {step}", atol=kw["lr"] * unit)
        _close_trees(ts["m"], js["m"], f"m step {step}", atol=1e-10)
        _close_trees(ts["v"], js["v"], f"v step {step}", atol=1e-15)
    if state_dtype == "int8":
        assert isinstance(ts["m"]["a"], dict) and ts["m"]["b"].dtype == \
            torch.float32 and not isinstance(ts["m"]["small"], dict)


def test_schedules_equal_jax():
    for schedule in ("cosine", "linear", "constant"):
        kw = dict(lr=3e-3, warmup_steps=7, total_steps=50, schedule=schedule)
        for step in (0, 1, 6, 7, 8, 23, 50, 60):
            want = float(jax.jit(lambda s: JA.schedule_lr(
                JA.AdamWConfig(**kw), s))(jnp.int32(step)))
            got = float(A.schedule_lr(A.AdamWConfig(**kw),
                                      torch.tensor(step, dtype=torch.int32)))
            np.testing.assert_allclose(got, want, rtol=ULP_RTOL,
                                       err_msg=f"{schedule} {step}")


def test_compression_equals_jax():
    rng = np.random.default_rng(3)
    grads = _tree(rng)
    ef = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 0.01).astype(
        jnp.bfloat16), grads)
    jc, jef = jax.jit(JC.compress_decompress)(grads, ef)
    tc, tef = C.compress_decompress(
        convert.params_from_numpy(grads, device="cpu"),
        convert.params_from_numpy(jax.tree.map(np.asarray, ef),
                                  device="cpu"))
    assert all(x.dtype == torch.float32 for x in TR.flatten(tc)[0])
    assert all(x.dtype == torch.bfloat16 for x in TR.flatten(tef)[0])
    _close_trees(tc, jc, "compressed", rtol=0)
    _close_trees(tef, jef, "residuals", rtol=0)
    zero = C.init_ef_state(convert.params_from_numpy(grads, device="cpu"))
    assert all(x.dtype == torch.bfloat16 and not x.any()
               for x in TR.flatten(zero)[0])


@pytest.fixture(scope="module")
def lm_step():
    """One LM train step of the reduced config, both packages, from one
    state: two microbatches, EF compression, int8 optimizer state."""
    arch = "xpikeformer-gpt-4-256"
    jcfg, tcfg = JR.reduced_config(arch), R.reduced_config(arch)
    kw = dict(microbatches=2, grad_compression=True, remat="block")
    jpar, tpar = JParallel(**kw), ParallelConfig(**kw)
    okw = dict(lr=LR, state_dtype="int8", warmup_steps=1, total_steps=10)
    jopt, topt = JA.AdamWConfig(**okw), A.AdamWConfig(**okw)
    jparams, jstate = JL.init_state(jax.random.PRNGKey(0), jcfg, jopt, jpar)
    tokens = JDP.MarkovStream(JDP.DataConfig(
        vocab_size=64, seq_len=16, global_batch=4, seed=2)).batch_at(0)
    rng = jax.random.PRNGKey(5)
    step = jax.jit(JL.make_train_step(jcfg, ParallelCtx(), jpar, jopt))
    jout = step(jparams, jstate, tokens, rng)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    tstate = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          device="cpu")
    tstep = L.make_train_step(tcfg, tpar, topt)
    tout = tstep(tparams, tstate, {"tokens": torch.from_numpy(
        np.asarray(tokens["tokens"]))}, torch.from_numpy(
        np.asarray(rng).astype(np.int64)))
    return jout, tout


def test_lm_train_step_equals_jax(lm_step):
    (jp, js, jm), (tp, ts, tm) = lm_step
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-3)
    _close_trees(tp, jp, "params", rtol=0, atol=PARAM_ATOL)
    assert set(ts) == {"m", "v", "step", "ef"}
    assert int(ts["step"]) == 1
    assert any(_is_q(m) for m in TR.flatten(ts["m"], _is_q)[0])
    assert all(g.dtype == torch.bfloat16 for g in TR.flatten(ts["ef"])[0])
    _close_trees(ts["ef"], js["ef"], "ef", rtol=0, atol=2e-3)


def test_lm_train_step_lowers_the_loss():
    """A few port steps on one batch (float32 state, no microbatches, no
    recomputation, gradients cast to bfloat16) lower the reduced LM's
    loss."""
    tcfg = R.reduced_config("xpikeformer-gpt-4-256")
    opt = A.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=20)
    params, state = L.init_state(0, tcfg, opt, device="cpu")
    data = MarkovStream(DataConfig(vocab_size=64, seq_len=16,
                                   global_batch=4, seed=2), device="cpu")
    batch = data.batch_at(0)
    step = L.make_train_step(tcfg, ParallelConfig(
        remat="none", grad_dtype="bfloat16"), opt)
    losses = []
    for i in range(4):
        params, state, m = step(params, state, batch, prng.PRNGKey(1))
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1]) and np.isfinite(float(m["grad_norm"]))
    assert losses[-1] < losses[0]
    with pytest.raises(ValueError, match="differentiable"):
        L.make_train_step(tcfg, backend="integer")


def test_markov_stream_equals_jax():
    cfg = dict(vocab_size=64, seq_len=16, global_batch=4, seed=3)
    js = JDP.MarkovStream(JDP.DataConfig(**cfg))
    ts = MarkovStream(DataConfig(**cfg), device="cpu")
    np.testing.assert_allclose(ts.logits.numpy(), np.asarray(js._logits),
                               rtol=2e-6, atol=1e-6)
    for step in (0, 5):
        want = np.asarray(js.batch_at(step)["tokens"])
        key = jax.random.fold_in(jax.random.PRNGKey(cfg["seed"] + 1), step)
        k0, k1 = jax.random.split(key)
        init = jax.random.randint(k0, (4, 2), 0, js._v)
        gum = jax.vmap(lambda kk: jax.random.gumbel(kk, (4, js._v)))(
            jax.random.split(k1, cfg["seq_len"] + 1))
        tkey = prng.fold_in(prng.PRNGKey(cfg["seed"] + 1), step)
        noise = ts.noise(tkey)
        np.testing.assert_array_equal(noise["init"].numpy(), np.asarray(init))
        np.testing.assert_allclose(noise["gumbel"].numpy(), np.asarray(gum),
                                   rtol=2e-6, atol=2e-6)
        ts.logits = torch.from_numpy(np.array(js._logits))
        got = ts.chain(torch.from_numpy(np.asarray(init).astype(np.int64)),
                       torch.from_numpy(np.asarray(gum)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(ts.batch_at(step)["tokens"].numpy(),
                                      want)
    half = ts.host_slice(ts.batch_at(0), 1, 2)["tokens"]
    np.testing.assert_array_equal(half.numpy(),
                                  ts.batch_at(0)["tokens"][2:].numpy())
    u = prng.categorical(prng.PRNGKey(4), torch.zeros(3, 5))
    np.testing.assert_array_equal(u.numpy(), np.asarray(
        jax.random.categorical(jax.random.PRNGKey(4), jnp.zeros((3, 5)))))
