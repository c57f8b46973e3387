"""The paper models' forward in the port against the JAX reference.

The spiking ViT (Table III) and GPT (Table IV) run here on the CPU, where
every kernel wrapper takes its plain PyTorch version.  Inputs are made
with numpy from a seed and handed to both packages; keys pass as the same
two uint32 words (the threefry twin draws JAX's bits from them).

* K8 (full-sequence SSA): the plain version equals ``repro.kernels.ref.
  ssa_attention_ref`` and the Pallas ``ssa_attention_packed`` in interpret
  mode, exactly, causal and not, at ``N`` in {16, 37, 64} and ``D`` in
  {16, 64}.
* K4 (LIF): the plain version equals ``repro.kernels.ref.lif_ref``
  exactly, with membranes exactly on the threshold.  The Pallas
  ``lif_fused`` cannot serve as a second oracle: on JAX 0.9.0 its kernel
  raises ``AttributeError`` (``pl.load`` is gone).
* The whole forward against ``repro.engine.IntegerBackend``: the spike
  trains out of the blocks, given JAX's rate-encoded input, are bitwise
  equal; the logits agree within 1e-4 (the float patch/embed and head
  matmuls and the sigmoid are the float boundary); the labels are equal.

``tests/test_torch_gpu.py`` holds the CUDA kernels against these plain
versions on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.configs import xpikeformer as JX
from repro.core import spikes as JSP
from repro.core import spiking_transformer as JST
from repro.data import icl_mimo as JMIMO
from repro.data import synthetic_images as JSI
from repro.kernels import ops as JKOPS
from repro.kernels import ref as JREF
from repro_torch import convert, prng
from repro_torch.configs import ModelConfig
from repro_torch.configs import xpikeformer as X
from repro_torch.core import spikes as SP
from repro_torch.core import spiking_transformer as ST
from repro_torch.data import icl_mimo as MIMO
from repro_torch.data import synthetic_images as SI
from repro_torch.engine import (CudaBackend, IntegerBackend,
                                XpikeformerEngine)
from repro_torch.kernels import aimc_matmul as KA
from repro_torch.kernels import lif as KL
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels import ref as KREF
from repro_torch.kernels import ssa_attention as KS


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _key(seed):
    """The same key for both packages: JAX's and the twin's."""
    jkey = jax.random.PRNGKey(seed)
    return jkey, _t(np.asarray(jkey).astype(np.int64))


def _eq(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want.astype(got.dtype)), (
        f"{np.sum(got != want)} of {got.size} elements differ")


# ---------------------------------------------------------------------------
# K8: the full SSA tile
# ---------------------------------------------------------------------------


def _ssa_inputs(n, d, causal):
    rng = np.random.default_rng(100 * n + d + causal)
    shape = (2, 1, 2, n, d)  # T, B, H, N, D: G = 4 tiles, flattened (t, b, h)
    q, k, v = ((rng.random(shape) < p).astype(np.uint8) for p in (0.5, 0.6, 0.4))
    return (q, k, v), _key(n + d + 7 * causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,d", [(16, 16), (16, 64), (37, 16), (37, 64),
                                 (64, 16), (64, 64)])
def test_ssa_attention_plain_equals_jax_oracle(n, d, causal):
    """On the same comparator integers the plain version (also through the
    CPU branch of the kernel's wrapper and the integer backend) is JAX's
    oracle.  That the twin draws JAX's integers is held by the Pallas
    comparison below, which draws inside each wrapper."""
    (q, k, v), (_, tkey) = _ssa_inputs(n, d, causal)
    g = 4
    rs, ra = KOPS.draw_comparator_prns(tkey, (g, n, n), (g, n, d), d, n)
    flat = [x.reshape(g, n, d) for x in (q, k, v)]
    want = JREF.ssa_attention_ref(*(jnp.asarray(x) for x in flat),
                                  jnp.asarray(rs.numpy()),
                                  jnp.asarray(ra.numpy()), causal=causal)
    assert 0 < int(np.sum(want)) < want.size  # neither silent nor saturated
    flat = [_t(x) for x in flat]
    _eq(KREF.ssa_attention_ref(*flat, rs, ra, causal=causal), want)
    _eq(KS.ssa_attention_kernel(*flat, rs, ra, causal=causal), want)
    _eq(IntegerBackend().ssa_attention(tkey, *(_t(x) for x in (q, k, v)),
                                       causal=causal),
        np.asarray(want).reshape(q.shape))


# every N and every D, each causal and not; the Pallas interpret run is
# the slow part of this file, so it takes these six of the twelve above
@pytest.mark.parametrize("n,d,causal", [(16, 16, False), (16, 64, True),
                                        (37, 16, True), (37, 64, False),
                                        (64, 16, False), (64, 64, True)])
def test_ssa_attention_packed_equals_pallas_interpret(n, d, causal):
    """The port's wrapper (draws, flatten order, plain version) equals the
    JAX wrapper running the Pallas kernel in interpret mode."""
    (q, k, v), (jkey, tkey) = _ssa_inputs(n, d, causal)
    want = JKOPS.ssa_attention_packed(*(jnp.asarray(x) for x in (q, k, v)),
                                      jkey, causal=causal, interpret=True)
    for got in (KOPS.ssa_attention_packed(_t(q), _t(k), _t(v), tkey,
                                          causal=causal),
                CudaBackend().ssa_attention(tkey, _t(q), _t(k), _t(v),
                                            causal=causal)):
        _eq(got, want)


def test_ssa_attention_causal_rows_see_no_later_key():
    """With every key after position i set, a causal row i sees none of
    them: the output of row 0 depends on key 0 alone."""
    n, d = 37, 16
    rng = np.random.default_rng(3)
    q = _t((rng.random((1, n, d)) < 0.5).astype(np.uint8))
    k = _t((rng.random((1, n, d)) < 0.5).astype(np.uint8))
    v = _t((rng.random((1, n, d)) < 0.5).astype(np.uint8))
    rs = torch.zeros((1, n, n), dtype=torch.int32)
    ra = torch.zeros((1, n, d), dtype=torch.int32)
    base = KREF.ssa_attention_ref(q, k, v, rs, ra, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, 1:], v2[:, 1:] = 1, 1
    _eq(KREF.ssa_attention_ref(q, k2, v2, rs, ra, causal=True)[:, 0], base[:, 0])


# ---------------------------------------------------------------------------
# K4: the LIF neuron
# ---------------------------------------------------------------------------


def _on_threshold(cur, beta, v_thresh=1.0):
    """How many membranes land exactly on the threshold (numpy, f32)."""
    v = np.zeros(cur.shape[1:], np.float32)
    hits = 0
    for c in cur:
        v = np.float32(beta) * v + c
        hits += int(np.sum(v == np.float32(v_thresh)))
        v = v * (1 - (v >= v_thresh))
    return hits


@pytest.mark.parametrize("beta,t,m,dyadic", [(0.5, 4, 1000, True),
                                             (0.25, 3, 257, True),
                                             (0.5, 8, 64, False),
                                             (0.75, 4, 333, False)])
def test_lif_plain_equals_jax(beta, t, m, dyadic):
    rng = np.random.default_rng(m)
    if dyadic:  # multiples of 1/8: many membranes exactly on the threshold
        cur = (rng.integers(-4, 12, (t, m)) / 8.0).astype(np.float32)
        assert _on_threshold(cur, beta) > 0
    else:
        cur = rng.normal(0.5, 0.6, (t, m)).astype(np.float32)
    want = JREF.lif_ref(jnp.asarray(cur), beta=beta)
    _eq(KREF.lif_ref(_t(cur), beta=beta), want)
    _eq(KL.lif_kernel(_t(cur), beta=beta), want)
    cur3 = cur.reshape(t, m, 1)
    for backend in (IntegerBackend(), CudaBackend()):
        _eq(backend.lif(_t(cur3), beta=beta), np.asarray(want).reshape(t, m, 1))
    _eq(KOPS.lif_fused(_t(cur3), beta=beta), JE.IntegerBackend().lif(
        jnp.asarray(cur3), beta=beta))


# ---------------------------------------------------------------------------
# The whole forward
# ---------------------------------------------------------------------------

# name, depth, batch: the smoke configs deepened to 2 blocks exercise the
# per-block fold_in(rng, i) keys; the paper ViT runs at its full width
# (d=384, its 64 patches) with one block (the keys of later blocks are the
# smoke cases')
FORWARD_CASES = {
    "vit-smoke": ("xpikeformer-vit-smoke", 2, 2),
    "gpt-smoke": ("xpikeformer-gpt-smoke", 2, 2),
    "vit-4-384": ("xpikeformer-vit-4-384", 1, 2),
}


def _inputs(task, cfg, batch, seed):
    if task == "vit":
        return SI.sample_batch(seed, SI.ImageConfig(size=cfg.image_size),
                               batch)["images"].numpy()
    return MIMO.sample_batch(seed, MIMO.MIMOConfig(), batch)["features"].numpy()


def _numpy_params(task, jcfg, seed):
    """A JAX parameter tree of ``init_vit``/``init_gpt``'s structure,
    filled from numpy: weights ``N(0, 1/d_in)``, biases and position rows
    ``N(0, 0.1^2)`` (non-zero, so the bias path counts)."""
    init = JST.init_vit if task == "vit" else JST.init_gpt
    shapes = jax.eval_shape(lambda k: init(k, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(sd):
        x = rng.standard_normal(sd.shape)
        x = x / np.sqrt(sd.shape[0]) if len(sd.shape) == 2 else 0.1 * x
        return jnp.asarray(x.astype(np.float32))

    return jax.tree.map(fill, shapes)


def _jax_forward(jcfg, task):
    """JAX's rate-encoded input, the spike trains out of its blocks and its
    logits (``vit_forward``/``gpt_forward``, what ``XpikeformerEngine.
    forward`` runs), on the integer backend, in one compile."""
    sim = JST.AIMCSim()
    backend = JE.IntegerBackend()
    fwd = JST.vit_forward if task == "vit" else JST.gpt_forward

    @jax.jit
    def run(params, x, rng):
        keys = jax.random.split(rng, 4)
        if task == "vit":
            h = JST.linear(params["patch"], JST.patchify(x, jcfg.patch_size),
                           sim, keys[0]) + params["pos"]
        else:
            h = JST.linear(params["embed"], x, sim, keys[0]) + \
                params["pos"][:x.shape[1]]
        s = JSP.rate_encode(keys[1], jax.nn.sigmoid(h), jcfg.T)
        out = JST._run_blocks(params, s, jcfg, sim, keys[2],
                              causal=task == "gpt", backend=backend)
        return s, out, fwd(params, x, jcfg, sim, rng, backend=backend)

    return run


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_equals_jax_integer_backend(case):
    name, depth, batch = FORWARD_CASES[case]
    task, jcfg = JX.SPIKING_ARCHS[name]
    jcfg = dataclasses.replace(jcfg, depth=depth)
    tcfg = dataclasses.replace(X.SPIKING_ARCHS[name][1], depth=depth)
    jparams = _numpy_params(task, jcfg, seed=7)
    x = _inputs(task, tcfg, batch, seed=len(case))
    jrng, trng = _key(11)
    js_in, js_out, jlogits = _jax_forward(jcfg, task)(
        jparams, jnp.asarray(x), jrng)
    jlogits = np.asarray(jlogits)

    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    for backend in ("integer", "cuda"):
        eng = XpikeformerEngine.from_config(tcfg, backend=backend,
                                            device="cpu")
        assert eng.task == task
        eng.params = tparams
        s_out = ST._run_blocks(tparams, _t(js_in), tcfg, prng.split(trng, 4)[2],
                               causal=task == "gpt", backend=eng.backend)
        assert s_out.dtype == torch.float32
        _eq(s_out, js_out)
        if backend == "integer":
            logits = eng.forward(_t(x), trng)
            assert logits.shape == jlogits.shape
            assert logits.dtype == torch.float32
            np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0,
                                       atol=1e-4)
        else:
            labels = (eng.classify if task == "vit" else eng.detect_symbols)(
                _t(x), trng)
            _eq(labels, np.argmax(jlogits, axis=-1))


def test_rate_coding_equals_jax():
    """``rate_encode`` with one key draws JAX's uniforms (``u < p``);
    ``rate_decode`` is the firing rate."""
    rng = np.random.default_rng(5)
    p = rng.random((3, 7, 5)).astype(np.float32)
    p[0, 0, :] = [0.0, 1.0, -0.5, 1.5, 0.5]  # clipped ends
    jkey, tkey = _key(21)
    want = JSP.rate_encode(jkey, jnp.asarray(p), 4)
    got = SP.rate_encode(tkey, _t(p), 4)
    _eq(got, want)
    _eq(SP.rate_decode(got), JSP.rate_decode(want))


def test_patchify_and_heads_equal_jax():
    """``patchify`` and ``spikes.heads``/``unheads`` move the reference's
    axes (``_heads``/``_unheads``)."""
    rng = np.random.default_rng(2)
    img = rng.random((2, 16, 16, 3)).astype(np.float32)
    _eq(ST.patchify(_t(img), 4), JST.patchify(jnp.asarray(img), 4))
    x = rng.random((3, 2, 5, 32)).astype(np.float32)
    heads = SP.heads(_t(x), 4)
    _eq(heads, JST._heads(jnp.asarray(x), 4))
    _eq(SP.unheads(heads), x)


# ---------------------------------------------------------------------------
# The engine facade, configs, parameters, data
# ---------------------------------------------------------------------------


def test_spiking_archs_equal_jax():
    assert sorted(X.SPIKING_ARCHS) == sorted(JX.SPIKING_ARCHS)
    for name, (task, cfg) in X.SPIKING_ARCHS.items():
        jtask, jcfg = JX.SPIKING_ARCHS[name]
        assert task == jtask
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (cfg.head_dim, cfg.num_patches) == (jcfg.head_dim, jcfg.num_patches)


@pytest.mark.parametrize("name,task", [
    ("xpikeformer-vit", None), ("xpikeformer-gpt", None),
    ("xpikeformer-vit-smoke", None), ("xpikeformer-gpt-4-256", None),
    ("xpikeformer-gpt-8-512", None), ("xpikeformer-gpt-4-256", "lm"),
    ("xpikeformer-gpt-8-512", "lm")])
def test_from_config_resolves_names_as_jax(name, task):
    jeng = JE.XpikeformerEngine.from_config(name, task=task)
    eng = XpikeformerEngine.from_config(name, task=task, device="cpu")
    assert eng.task == jeng.task
    assert type(eng.cfg).__name__ == type(jeng.cfg).__name__
    assert dataclasses.asdict(eng.cfg) == dataclasses.asdict(jeng.cfg)


def test_from_config_resolution_edges():
    red = XpikeformerEngine.from_config("xpikeformer-gpt-4-256", task="lm",
                                        reduced=True, device="cpu")
    jred = JE.XpikeformerEngine.from_config("xpikeformer-gpt-4-256",
                                            task="lm", reduced=True)
    assert dataclasses.asdict(red.cfg) == dataclasses.asdict(jred.cfg)
    with pytest.raises(KeyError):
        XpikeformerEngine.from_config("xpikeformer-vit", task="lm",
                         device="cpu")
    with pytest.raises(KeyError):
        XpikeformerEngine.from_config("no-such-arch", device="cpu")
    gcfg = X.SPIKING_ARCHS["xpikeformer-gpt-smoke"][1]
    vcfg = X.SPIKING_ARCHS["xpikeformer-vit-smoke"][1]
    assert XpikeformerEngine.from_config(gcfg, device="cpu").task == "gpt"
    assert XpikeformerEngine.from_config(vcfg, device="cpu").task == "vit"
    lm = XpikeformerEngine.from_config(red.cfg, device="cpu")
    assert lm.task == "lm" and isinstance(lm.cfg, ModelConfig)


def test_paper_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("xpikeformer-vit", "xpikeformer-gpt"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            XpikeformerEngine.from_config(name)
        eng = XpikeformerEngine.from_config(name, device="cpu")
        assert eng.device.type == "cpu" and eng.backend.name == "cuda"


def test_unported_modes_raise():
    """Legacy ``{"hw": dict}`` leaves (A12) raise, naming their ROADMAP
    item; hardware-aware training's noisy forward (A11, ported: held to the
    reference in ``tests/test_torch_train.py``), the baseline modes (A7,
    ``tests/test_torch_modes.py``) and the LM stack's forward (A1,
    ``tests/test_torch_lm_forward.py``) run, and so does the
    programmed-PCM lifecycle (A8, ``tests/test_torch_pcm.py``)."""
    vcfg = X.SPIKING_ARCHS["xpikeformer-vit-smoke"][1]
    for mode in ("ann", "lif"):
        beng = XpikeformerEngine.from_config(
            dataclasses.replace(vcfg, mode=mode), device="cpu")
        beng.init(0)
        out = beng.forward(torch.zeros((1, 16, 16, 3)), prng.PRNGKey(0))
        assert out.shape == (1, vcfg.num_classes)
        assert bool(torch.isfinite(out).all())
    heng = XpikeformerEngine.from_config(vcfg, wmode="hwat",
                                         backend="reference", device="cpu")
    heng.init(0)
    out = heng.forward(torch.zeros((1, 16, 16, 3)), prng.PRNGKey(0))
    assert out.shape == (1, vcfg.num_classes)
    assert bool(torch.isfinite(out).all())
    assert XpikeformerEngine.from_config(
        "xpikeformer-gpt-4-256", task="lm", reduced=True, wmode="hwat",
        device="cpu").wmode == "hwat"
    eng = XpikeformerEngine.from_config(vcfg, wmode="hw", device="cpu")
    assert eng.wmode == "hw"
    eng.init(0)
    img = torch.zeros((1, 16, 16, 3))
    key = prng.PRNGKey(0)
    legacy = {"hw": {"levels": torch.ones(48, 2)}, "b": torch.zeros(2)}
    with pytest.raises(NotImplementedError, match="A12"):
        ST.linear(legacy, img.reshape(1, 16, 48))
    with pytest.raises(NotImplementedError, match="A12"):
        IntegerBackend().spiking_linear(legacy, torch.zeros((1, 1, 48)))
    ann = ST.vit_forward(eng.params, img, dataclasses.replace(vcfg, mode="ann"),
                         key, backend=eng.backend)
    assert ann.shape == (1, vcfg.num_classes)
    lm = XpikeformerEngine.from_config("xpikeformer-gpt-4-256", task="lm",
                                       reduced=True, device="cpu")
    lm.init(0)
    logits = lm.forward(torch.zeros((1, 4), dtype=torch.int64), key)
    assert logits.shape == (1, 4, lm.cfg.vocab_size)
    with pytest.raises(ValueError, match="task='lm'"):
        eng.scheduler()


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("name", ["xpikeformer-vit-4-384",
                                  "xpikeformer-gpt-4-256",
                                  "xpikeformer-vit-smoke",
                                  "xpikeformer-gpt-smoke"])
def test_params_have_the_jax_tree(name):
    """The port's own init and the converted JAX init have the JAX tree's
    structure and shapes, f32 throughout."""
    task, jcfg = JX.SPIKING_ARCHS[name]
    jinit = JST.init_vit if task == "vit" else JST.init_gpt
    want = _shapes(jax.eval_shape(lambda k: jinit(k, jcfg),
                                  jax.random.PRNGKey(0)))
    eng = XpikeformerEngine.from_config(name, device="cpu")
    params = eng.init(3)
    assert _shapes(params) == want
    assert all(x.dtype == torch.float32 for x in jax.tree.leaves(params))
    if name.endswith("smoke"):
        jparams = jax.jit(lambda k: jinit(k, jcfg))(jax.random.PRNGKey(0))
        conv = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         device="cpu")
        assert _shapes(conv) == want
        _eq(conv["blocks"][0]["wq"]["w"], jparams["blocks"][0]["wq"]["w"])


def test_class_bits_and_ber_equal_jax():
    rng = np.random.default_rng(9)
    cfg, jcfg = MIMO.MIMOConfig(), JMIMO.MIMOConfig()
    cls = rng.integers(0, 16, (4, 37))
    _eq(MIMO.class_bits(_t(cls), 2), JMIMO.class_bits(jnp.asarray(cls), 2))
    logits = rng.normal(size=(4, 37, 16)).astype(np.float32)
    mask = np.zeros((4, 37), np.float32)
    mask[:, 0::2] = 1
    got = MIMO.ber(_t(logits), _t(cls), _t(mask), cfg)
    want = JMIMO.ber(jnp.asarray(logits), jnp.asarray(cls), jnp.asarray(mask),
                     jcfg)
    assert float(got) == float(want)


def test_data_twins_have_the_reference_layout():
    """The shapes and dtypes of the JAX generators, values in range, and
    the ICL token layout: queries hold ``y`` and no one-hot, answers one
    one-hot (of the preceding query's label) and no ``y``.  The draws
    themselves differ from JAX's: inputs are data."""
    img = SI.sample_batch(0, SI.ImageConfig(), 8)
    jimg = jax.eval_shape(lambda k: JSI.sample_batch(k, JSI.ImageConfig(), 8),
                          jax.random.PRNGKey(0))
    assert tuple(img["images"].shape) == jimg["images"].shape
    assert img["images"].dtype == torch.float32
    assert 0 <= float(img["images"].min()) and float(img["images"].max()) <= 1
    assert 0 <= int(img["labels"].min()) and int(img["labels"].max()) < 10
    assert len(set(img["labels"].tolist())) > 1

    cfg = MIMO.MIMOConfig()
    b = MIMO.sample_batch(1, cfg, 4)
    jb = jax.eval_shape(lambda k: JMIMO.sample_batch(k, JMIMO.MIMOConfig(), 4),
                        jax.random.PRNGKey(1))
    for name in ("features", "labels", "mask"):
        assert tuple(b[name].shape) == jb[name].shape, name
    f, lab = b["features"].numpy(), b["labels"].numpy()
    assert f.shape == (4, cfg.seq_len, cfg.feat_dim)
    assert np.all(f[:, 0::2, :4] != 0) and np.all(f[:, 0::2, 4:] == 0)
    assert np.all(f[:, 1::2, :4] == 0) and np.all(f[:, 1::2, 4:].sum(-1) == 1)
    _eq(np.argmax(f[:, 1::2, 4:], -1), lab[:, 0:-1:2])
    assert np.all(lab[:, 1::2] == 0)
    _eq(b["mask"][:, 0::2], np.ones((4, cfg.pairs + 1)))
    _eq(b["mask"][:, 1::2], np.zeros((4, cfg.pairs)))


def test_paper_path_hands_the_kernels_their_operands(monkeypatch):
    """Every tensor the paper forward hands K1 (and ``lif`` hands K4) is
    contiguous and of the kernel's dtype, and K8's keyed entry gets uint8
    heads views with contiguous rows (read in place, no copy) and an int64
    key -- what the CUDA branch checks and raises on, rehearsed through the
    plain versions."""
    seen = []

    def checked(fn, dtypes, rows_only=False):
        def run(*args, **kw):
            for a, dt in zip(args, dtypes):
                if isinstance(a, torch.Tensor):
                    if rows_only and a.dim() == 5:
                        assert a.stride(-1) == 1, fn.__name__
                    else:
                        assert a.is_contiguous(), fn.__name__
                    assert dt is None or a.dtype == dt, (fn.__name__, a.dtype)
            seen.append(fn.__name__)
            return fn(*args, **kw)
        return run

    f32, u8, i8, i64 = torch.float32, torch.uint8, torch.int8, torch.int64
    monkeypatch.setattr(KA, "aimc_spiking_linear_kernel", checked(
        KA.aimc_spiking_linear_kernel, (f32, i8, f32, f32)))
    monkeypatch.setattr(KS, "ssa_attention_keyed_kernel", checked(
        KS.ssa_attention_keyed_kernel, (u8, u8, u8, i64), rows_only=True))
    monkeypatch.setattr(KL, "lif_kernel", checked(KL.lif_kernel, (f32,)))
    key = prng.PRNGKey(4)
    for name in ("xpikeformer-vit-smoke", "xpikeformer-gpt-smoke"):
        eng = XpikeformerEngine.from_config(name, device="cpu")
        eng.init(1)
        task, cfg = X.SPIKING_ARCHS[name]
        x = torch.from_numpy(_inputs(task, cfg, 2, seed=1))
        out = eng.forward(x, key)
        assert bool(torch.isfinite(out).all())
    eng.backend.lif(torch.randn(5, 3, 4).permute(2, 1, 0))
    assert {"aimc_spiking_linear_kernel", "ssa_attention_keyed_kernel",
            "lif_kernel"} <= set(seen)
