"""The port's training path against the JAX package, on the CPU.

Held to the reference's jitted functions (its training steps are jitted):

* the surrogates (``heaviside_st``, ``bernoulli_st``), the crossbar STE
  and the clip's gradient equal JAX's custom VJPs bit for bit on a
  hypothesis fuzz, ties included (``jnp.clip``'s gradient at a tie is
  0.5); the float LIF's spikes equal and its gradients within 1e-6;
* the float reference backend: ``ssa_attention`` at N in {16, 37}, causal
  and not (spikes equal, q/k/v gradients within ``SSA_GRAD_ATOL``);
  ``spiking_linear`` with ideal, HWAT and programmed weights (spikes
  equal; HWAT given JAX's ``erf_inv`` of its normals, the float boundary);
  ``decode_attention`` dense and paged (spikes equal);
* one CT and one HWAT step of the paper ViT and GPT smoke configs: the
  loss within ``LOSS_ATOL`` and every gradient leaf within ``GRAD_RTOL``
  of its largest entry (HWAT given JAX's ``erf_inv``);
* a short ``two_stage_train`` on one fixed batch, and the example twins
  end to end at a few steps.  (``--backend reference`` serving is held to
  JAX's in ``tests/test_torch_serving.py``.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax import lax

from repro.configs.xpikeformer import SPIKING_ARCHS as JARCHS
from repro.core import aimc as JAM
from repro.core import spikes as JSP
from repro.core import spiking_transformer as JST
from repro.core import ssa as JSSA
from repro.data import icl_mimo as JICL
from repro.data import synthetic_images as JIMG
from repro.engine import ReferenceBackend as JReference
from repro.kernels.plan import AttnSpec as JAttnSpec
from repro.kernels.plan import KVView as JKVView
from repro.train import hwat as JH
from repro_torch import aimc_device as AD
from repro_torch import convert
from repro_torch.configs.xpikeformer import SPIKING_ARCHS
from repro_torch.core import aimc as AM
from repro_torch.core import spikes as SP
from repro_torch.core import spiking_transformer as ST
from repro_torch.engine import ReferenceBackend
from repro_torch.kernels.plan import AttnSpec, KVView
from repro_torch.train import hwat as H
from repro_torch.train.loop import value_and_grad

REF = ReferenceBackend()
JREF = JReference()
_SET = dict(max_examples=8, deadline=None)
# q/k/v gradients of the float SSA: exact counts, float einsums of the
# cotangents summed in other orders
SSA_GRAD_ATOL = 1e-6
# one training step of a smoke model: the loss (float head, mean), and
# each gradient leaf against its largest entry (surrogate chains through
# float matmuls summed in other orders)
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
LIF_GRAD_ATOL = 1e-6
_LO = float(np.nextafter(np.float32(-1), np.float32(0)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _tkey(jkey):
    return _t(np.asarray(jkey).astype(np.int64))


def _eq(got, want, msg=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want).astype(got.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    bad = int(np.sum(got != want))
    assert bad == 0, f"{msg}: {bad} of {got.size} differ"


def _out_and_grads(f, r, *args):
    """``f(*args)`` and the gradients of ``sum(f * r)``: one compile."""
    def run(*a):
        out, vjp = jax.vjp(f, *a)
        return out, vjp(jnp.asarray(r, out.dtype))

    out, grads = jax.jit(run)(*args)
    return np.asarray(out), grads


def _spikes(rng, shape, p):
    return (rng.random(shape) < p).astype(np.float32)


def jax_erfinv(key, shape):
    """``erf_inv`` of JAX's normal uniforms under ``jit``: the float
    boundary HWAT's and the read noise's normals pass."""
    k = jnp.asarray(key.cpu().numpy().astype(np.uint32))
    e = jax.jit(lambda kk: lax.erf_inv(jax.random.uniform(
        kk, shape, jnp.float32, _LO, 1.0)))(k)
    return torch.from_numpy(np.array(e)).to(key.device)


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's HWAT draws JAX's ``erf_inv`` (the uniforms are the
    twin's, bit for bit; only ``erfinv`` differs in the last bits)."""
    monkeypatch.setattr(AM.prng, "normal_erfinv", jax_erfinv)


# ---------------------------------------------------------------------------
# Surrogates, STE, clip, float LIF
# ---------------------------------------------------------------------------


@settings(**_SET)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 300),
       ties=st.integers(0, 20))
def test_surrogates_equal_jax_custom_vjps(seed, n, ties):
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=n) * rng.choice([0.01, 1.0, 30.0])).astype(np.float32)
    v[:min(ties, n)] = 0.0
    g = rng.normal(size=n).astype(np.float32)
    u = rng.random(n).astype(np.float32)
    p = rng.random(n).astype(np.float32)
    p[:min(ties, n)] = u[:min(ties, n)]  # a sampler tie: u < p is false

    def jvjp(f, *xs):
        out, vjp = jax.vjp(f, *xs)
        return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]

    jh, (jgv,) = jvjp(jax.jit(lambda x: JSP.heaviside_st(x, 2.0)), v)
    tv = _t(v).requires_grad_()
    out = SP.heaviside_st(tv, 2.0)
    out.backward(_t(g))
    _eq(out, jh, "heaviside")
    _eq(tv.grad, jgv, "heaviside surrogate")

    jb, (jgp, _) = jvjp(jax.jit(JSP.bernoulli_st), p, u)
    tp = _t(p).requires_grad_()
    out = SP.bernoulli_st(tp, _t(u))
    out.backward(_t(g))
    _eq(out, jb, "bernoulli")
    _eq(tp.grad, jgp, "bernoulli straight-through")

    w = rng.normal(size=n).astype(np.float32)
    js, (jgw, _) = jvjp(jax.jit(JAM._ste), w, p)
    tw = _t(w).requires_grad_()
    out = AM._ste(tw, _t(p))
    out.backward(_t(g))
    _eq(out, js, "ste")
    _eq(tw.grad, jgw, "ste gradient")

    x = np.concatenate([v, [0.0, 1.0], p]).astype(np.float32)
    jc = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(
        jnp.clip(a, 0.0, 1.0))))(x))
    tx = _t(x).requires_grad_()
    SP.clip01(tx).sum().backward()
    _eq(tx.grad, jc, "clip gradient")
    assert float(tx.grad[n]) == 0.5 and float(tx.grad[n + 1]) == 0.5


def test_float_lif_equals_jax():
    rng = np.random.default_rng(1)
    cur = (rng.normal(size=(5, 3, 40)) * 0.9 + 0.4).astype(np.float32)
    r = rng.normal(size=cur.shape).astype(np.float32)
    f = jax.jit(lambda c: jnp.sum(JSP.lif(c) * r))
    js = np.asarray(jax.jit(JSP.lif)(cur))
    jg = np.asarray(jax.grad(f)(cur))
    tc = _t(cur).requires_grad_()
    out = REF.lif(tc)
    _eq(out, js, "lif spikes")
    assert 0 < float(out.detach().sum()) < out.numel()
    (out * _t(r)).sum().backward()
    np.testing.assert_allclose(tc.grad.numpy(), jg, rtol=0,
                               atol=LIF_GRAD_ATOL)


# ---------------------------------------------------------------------------
# The reference backend's primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,causal", [(16, False), (16, True), (37, False),
                                      (37, True)])
def test_reference_ssa_attention_equals_jax(n, causal):
    rng = np.random.default_rng(n + causal)
    qkv = [_spikes(rng, (3, 2, 2, n, 16), p) for p in (0.5, 0.6, 0.4)]
    r = rng.normal(size=qkv[0].shape).astype(np.float32)
    key = jax.random.PRNGKey(7 + n)

    def f(q, k, v):
        return JSSA.ssa_attention(key, q, k, v, causal=causal)

    jo, jg = _out_and_grads(f, r, *qkv)
    ts = [_t(x).requires_grad_() for x in qkv]
    out = REF.ssa_attention(_tkey(key), *ts, causal=causal)
    _eq(out, jo, "ssa spikes")
    assert 0 < float(out.detach().sum()) < out.numel()
    (out * _t(r)).sum().backward()
    for name, a, b in zip("qkv", jg, ts):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), rtol=0,
                                   atol=SSA_GRAD_ATOL, err_msg=name)
    # a model rank's head (h0 = 1 of 2) draws the whole call's comparators
    # of that head
    one = REF.ssa_attention(_tkey(key), *(x.detach()[:, :, 1:] for x in ts),
                            causal=causal, h0=1, heads=2)
    _eq(one, out.detach()[:, :, 1:].numpy(), "ssa spikes of head 1")


def _linear_case(rng, d_in=48, d_out=40):
    spikes = _spikes(rng, (3, 2, 5, d_in), 0.4)
    w = (rng.normal(size=(d_in, d_out)) * 2.5 / np.sqrt(d_in)).astype(
        np.float32)
    b = (rng.normal(size=d_out) * 0.1).astype(np.float32)
    return spikes, w, b


@pytest.mark.parametrize("wmode", ["ideal", "hwat"])
def test_reference_spiking_linear_equals_jax(wmode, jax_noise):
    rng = np.random.default_rng(3)
    spikes, w, b = _linear_case(rng)
    key = jax.random.PRNGKey(11)
    jsim = JST.AIMCSim(wmode=wmode)
    r = rng.normal(size=(3, 2, 5, w.shape[1])).astype(np.float32)

    def f(s, ww, bb):
        return JREF.spiking_linear(key, {"w": ww, "b": bb}, s, jsim)

    jo, jg = _out_and_grads(f, r, spikes, w, b)
    ts, tw, tb = (_t(x).requires_grad_() for x in (spikes, w, b))
    out = REF.spiking_linear({"w": tw, "b": tb}, ts, key=_tkey(key),
                             sim=ST.AIMCSim(wmode=wmode))
    _eq(out, jo, f"{wmode} spikes")
    assert 0 < float(out.detach().sum()) < out.numel()
    (out * _t(r)).sum().backward()
    for name, a, x in zip(("spikes", "w", "b"), jg, (ts, tw, tb)):
        a = np.asarray(a)
        np.testing.assert_allclose(x.grad.numpy(), a, rtol=0,
                                   atol=GRAD_RTOL * np.abs(a).max(),
                                   err_msg=name)


def test_hwat_weights_equal_jax_given_its_erfinv():
    """HWAT's noisy weights as XLA computes them (the constant factor
    folded, the noisy level one fused multiply-add), bit for bit, given
    JAX's ``erf_inv``; the twin's own ``erfinv`` agrees within a few
    ulps."""
    rng = np.random.default_rng(5)
    cfg = JAM.AIMCConfig()
    for shape in ((32, 48), (128, 96)):
        w = rng.normal(size=shape).astype(np.float32)
        key = jax.random.PRNGKey(shape[1])
        want = np.asarray(jax.jit(lambda k, x: JAM.hwat_weights(k, x, cfg))(
            key, w))
        got = AM.hwat_from_erfinv(_t(w), jax_erfinv(_tkey(key), shape),
                                  AM.AIMCConfig())
        _eq(got, want, f"hwat {shape}")
        own = AM.hwat_weights(_tkey(key), _t(w), AM.AIMCConfig()).numpy()
        np.testing.assert_allclose(own, want, rtol=0, atol=2e-6)


def test_reference_spiking_linear_programmed_equals_jax():
    """Programmed state through the analog simulation, the same read
    noise at every timestep (the reference ``vmap``s one key over T)."""
    rng = np.random.default_rng(4)
    spikes, w, b = _linear_case(rng, d_in=160)
    jcfg = JAM.AIMCConfig()
    from repro import aimc_device as JAD

    jp = JAD.program_tree(jax.random.PRNGKey(2), {"lin": {"w": w, "b": b}},
                          jcfg)["lin"]
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    assert isinstance(tp["hw"], AD.AIMCDeviceState)
    for key in (None, jax.random.PRNGKey(9)):
        want = np.asarray(jax.jit(lambda s: JREF.spiking_linear(
            key, jp, s, JST.AIMCSim(wmode="hw", cfg=jcfg)))(spikes))
        got = REF.spiking_linear(tp, _t(spikes),
                                 key=None if key is None else _tkey(key),
                                 sim=ST.AIMCSim(wmode="hw"))
        _eq(got, want, f"programmed, key {key is not None}")
        assert 0 < float(got.detach().sum()) < got.numel()


@pytest.mark.parametrize("paged", [False, True])
def test_reference_decode_attention_equals_jax(paged):
    rng = np.random.default_rng(6 + paged)
    t, b, h, d, pl, mp = 3, 3, 4, 16, 5, 5
    lcap = pl * mp
    q = _spikes(rng, (t, b, h, 1, d), 0.5).astype(np.uint8)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(b, dtype=jnp.uint32) + 3)
    pos = np.array([7, 0, lcap - 1])
    if paged:
        kv = 2
        pools = [_spikes(rng, (12, t, kv, pl, d), 0.5).astype(np.uint8)
                 for _ in range(2)]
        for x in pools:
            x[0] = 0  # the null page
        table = rng.integers(1, 12, size=(b, mp)).astype(np.int32)
        table[1, 2:] = 0
        jview = JKVView.from_pool(*pools, table)
        tview = KVView.from_pool(_t(pools[0]), _t(pools[1]), _t(table))
        spec = dict(i_max=lcap, h0=1)
        jspec = JAttnSpec(groups=h // kv, **spec)
    else:
        cache = [_spikes(rng, (t, b, h, lcap, d), 0.5).astype(np.uint8)
                 for _ in range(2)]
        for x in cache:
            for i, p in enumerate(pos):
                x[:, i, :, p + 1:] = 0
        jview = JKVView.dense(*cache)
        tview = KVView.dense(_t(cache[0]), _t(cache[1]))
        spec = dict(i_max=lcap, h0=2)
        jspec = JAttnSpec(**spec)
    want = np.asarray(jax.jit(lambda view, qq, kk: JREF.decode_attention(
        view, qq, jspec, slot_keys=kk))(jview, q, keys))
    got = REF.decode_attention(tview, _t(q), AttnSpec(**spec),
                               slot_keys=_tkey(keys))
    _eq(got, want, "decode")
    assert 0 < float(got.sum()) < got.numel()


# ---------------------------------------------------------------------------
# One training step of the paper models; a short two-stage run
# ---------------------------------------------------------------------------


def _batch(task, n=4):
    if task == "vit":
        jb = JIMG.sample_batch(jax.random.PRNGKey(1),
                               JIMG.ImageConfig(size=16), n)
    else:
        jb = JICL.sample_batch(jax.random.PRNGKey(1), JICL.MIMOConfig(), n)
    jb = {k: np.asarray(v) for k, v in jb.items()}
    tb = {k: _t(v) for k, v in jb.items()}
    return jb, tb


def _setup(task):
    name = f"xpikeformer-{task}-smoke"
    jcfg, tcfg = JARCHS[name][1], SPIKING_ARCHS[name][1]
    init = JST.init_vit if task == "vit" else JST.init_gpt
    jparams = init(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    jfwd_ = JST.vit_forward if task == "vit" else JST.gpt_forward
    field = "images" if task == "vit" else "features"

    def jfwd(p, bt, sim, rng):
        return jfwd_(p, bt[field], jcfg, sim, rng)

    return jcfg, tcfg, jparams, tparams, jfwd, H.model_forward(tcfg, task)


def _leaf_close(got, want, name):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GRAD_RTOL * scale, err_msg=name)


# the first step of a stage from seed 4: split(fold_in(PRNGKey(4), 0))[1]
STEP_KEY = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(4), 0))[1]
_JAX_STEPS = {}


def jax_step(task, wmode):
    """The reference's jitted loss and gradients of one step from
    ``STEP_KEY`` on ``_batch(task)``, computed once a module."""
    if (task, wmode) not in _JAX_STEPS:
        jcfg, _, jparams, _, jfwd, _ = _setup(task)
        jb, _ = _batch(task)

        def jloss(p, bt, r):
            logits = jfwd(p, bt, JST.AIMCSim(wmode=wmode), r)
            return JH.xent_loss(logits, bt["labels"], bt.get("mask"))

        _JAX_STEPS[task, wmode] = jax.jit(jax.value_and_grad(jloss))(
            jparams, jb, STEP_KEY)
    return _JAX_STEPS[task, wmode]


@pytest.mark.parametrize("task", ["vit", "gpt"])
@pytest.mark.parametrize("wmode", ["ideal", "hwat"])
def test_train_step_equals_jax(task, wmode, jax_noise):
    """One CT (``ideal``) or HWAT step: the loss and every gradient leaf
    of the reference's jitted ``value_and_grad``."""
    jcfg, tcfg, jparams, tparams, jfwd, tfwd = _setup(task)
    jb, tb = _batch(task)
    rng = STEP_KEY
    jl, jg = jax_step(task, wmode)

    def tloss(p, bt, r):
        logits = tfwd(p, bt, ST.AIMCSim(wmode=wmode), r)
        return H.xent_loss(logits, bt["labels"], bt.get("mask")), {}

    (tl, _), tg = value_and_grad(tloss)(tparams, tb, _tkey(rng))
    assert abs(float(tl) - float(jl)) <= LOSS_ATOL, (float(tl), float(jl))
    jleaves = jax.tree.leaves(jg)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    tmap = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            tmap[path] = t

    walk(tg, ())
    assert len(tmap) == len(jleaves)
    for path, leaf in jflat:
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        _leaf_close(tmap[key], leaf, f"{task} {wmode} {key}")
    assert any(float(torch.abs(x).max()) > 0 for x in tmap.values())


def test_two_stage_train_lowers_the_loss_on_a_fixed_batch():
    """CT then HWAT on the GPT smoke config, one batch every step: the
    port's curve starts at the reference's first loss and falls."""
    jcfg, tcfg, jparams, tparams, jfwd, tfwd = _setup("gpt")
    jb, tb = _batch("gpt")
    _, curves = H.two_stage_train(tparams, tfwd, lambda k: tb, ct_steps=4,
                                  hwat_steps=2, lr=3e-3, seed=4)
    ct = curves["ct"]
    assert len(ct) == 4 and len(curves["hwat"]) == 2
    assert all(np.isfinite(ct + curves["hwat"]))
    assert min(ct[1:]) < ct[0]
    assert abs(ct[0] - float(jax_step("gpt", "ideal")[0])) <= LOSS_ATOL


def test_train_and_program_gives_device_state():
    tcfg = SPIKING_ARCHS["xpikeformer-gpt-smoke"][1]
    params = ST.init_gpt(tcfg, 0, "cpu")
    _, tb = _batch("gpt")
    hw, curves = H.train_and_program(params, H.model_forward(tcfg),
                                     lambda k: tb, ct_steps=1, hwat_steps=1)
    assert isinstance(hw["blocks"][0]["wq"]["hw"], AD.AIMCDeviceState)
    assert len(curves["ct"]) == 1 and len(curves["hwat"]) == 1


@pytest.fixture
def one_thread():
    """Torch's CPU ops on one thread for the test: the examples run
    thousands of tiny ops, and each op's thread team waits on threads the
    other test workers hold (about 50x slower on a busy host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_example_twins_run_end_to_end(one_thread):
    from repro_torch.examples import icl_symbol_detection, image_classify

    out = image_classify.main(["--device", "cpu", "--steps", "2", "--depth",
                               "1", "--dim", "32", "--T", "3",
                               "--eval-batch", "16", "--backend", "cuda"])
    assert 0.0 <= out["accuracy"] <= 1.0
    out = icl_symbol_detection.main(["--device", "cpu", "--steps", "2",
                                     "--T", "3", "--eval-batch", "8",
                                     "--backend", "integer"])
    assert all(0.0 <= out[k] <= 1.0 for k in (
        "deploy (t=0)", "1 year, no GDC", "1 year, GDC"))


def test_training_entry_points_default_to_the_card():
    tcfg = SPIKING_ARCHS["xpikeformer-vit-smoke"][1]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ST.init_vit(tcfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_numpy({"w": np.zeros(2, np.float32)})
    from repro_torch.data.pipeline import DataConfig, MarkovStream

    with pytest.raises(RuntimeError, match="device='cpu'"):
        MarkovStream(DataConfig(vocab_size=8, seq_len=4, global_batch=2))
