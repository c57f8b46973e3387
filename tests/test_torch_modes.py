"""The paper models' baseline modes in the port against the JAX package.

Tables III and IV compare Xpikeformer (``mode="ssa"``, held in
``tests/test_torch_paper.py``) with two baselines that the same module
runs: ``"lif"`` (Spikformer: the spiking blocks with the LIF attention
``LIF(LIF(Q K^T) V)`` in place of SSA) and ``"ann"`` (the float
transformer: LayerNorm, softmax attention, GELU).  On the CPU, on the
ViT and GPT smoke configs deepened to 2 blocks, with weights and inputs
made with numpy from a seed and handed to both packages:

* ``lif``: given JAX's rate-encoded input, the spike trains out of the
  blocks equal JAX's ``IntegerBackend``'s bit for bit, on both port
  backends; the logits agree within ``ATOL`` (the float embed and head
  and the sigmoid are the float boundary) and the labels are equal;
* ``ann``: the logits agree within ``ATOL`` and the labels are equal; no
  backend changes them (no spiking primitive runs);
* ``lif_spiking_attention`` alone equals JAX's exactly at ``N`` in {16,
  37, 64}, causal and not (``/ d`` and ``/ N`` taken as XLA takes a
  division by a constant, through the float32 reciprocal), and
  ``ann_attention`` within float rounding.
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
from repro.core import ssa as JSSA
from repro_torch import convert, prng
from repro_torch.configs import xpikeformer as X
from repro_torch.core import spiking_transformer as ST
from repro_torch.core import ssa as SSA
from repro_torch.data import icl_mimo as MIMO
from repro_torch.data import synthetic_images as SI
from repro_torch.engine import XpikeformerEngine

# the float embed / head matmuls (and, for "ann", LayerNorm, softmax and
# GELU): XLA and PyTorch round in other orders
ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _eq(got, want, what=""):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got, want.astype(got.dtype)), (
        f"{what}: {np.sum(got != want)} of {got.size} elements differ")


def _key(seed):
    jkey = jax.random.PRNGKey(seed)
    return jkey, _t(np.asarray(jkey).astype(np.int64))


# ---------------------------------------------------------------------------
# The attentions alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [16, 37, 64])
def test_lif_attention_equals_jax(n, causal):
    """Dense enough trains that both membranes fire and many land on the
    threshold's neighbourhood: every spike equals JAX's."""
    rng = np.random.default_rng(n + causal)
    q, k, v = ((rng.random((5, 2, 3, n, 16)) < p).astype(np.float32)
               for p in (0.8, 0.9, 0.7))
    want = JSSA.lif_spiking_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                      causal=causal)
    got = SSA.lif_spiking_attention(*(_t(x) for x in (q, k, v)),
                                    causal=causal)
    assert got.dtype == torch.float32
    _eq(got, want)
    assert 0 < float(got.sum()) < got.numel()


def test_mul_reciprocal_is_xlas_division_by_a_constant():
    """At ``N = 37`` a true division differs from XLA's; the product with
    the float32 reciprocal equals it for every count."""
    c = np.arange(0, 38, dtype=np.float32)
    want = np.asarray(jax.jit(lambda x: x / 37)(jnp.asarray(c)))
    _eq(SSA.mul_reciprocal(_t(c), 37), want)
    assert not np.array_equal(c / np.float32(37), want)


@pytest.mark.parametrize("causal", [False, True])
def test_ann_attention_equals_jax(causal):
    rng = np.random.default_rng(3 + causal)
    q, k, v = (rng.standard_normal((2, 3, 37, 16)).astype(np.float32)
               for _ in range(3))
    want = JSSA.ann_attention(*(jnp.asarray(x) for x in (q, k, v)),
                              causal=causal)
    got = SSA.ann_attention(*(_t(x) for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The whole forwards
# ---------------------------------------------------------------------------

NAMES = ("xpikeformer-vit-smoke", "xpikeformer-gpt-smoke")


def _setup(name, mode):
    task, jcfg = JX.SPIKING_ARCHS[name]
    jcfg = dataclasses.replace(jcfg, depth=2, mode=mode)
    tcfg = dataclasses.replace(X.SPIKING_ARCHS[name][1], depth=2, mode=mode)
    init = JST.init_vit if task == "vit" else JST.init_gpt
    shapes = jax.eval_shape(lambda k: init(k, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(len(name) + len(mode))

    def fill(sd):  # weights N(0, 1/d_in); biases, positions, norms 0.1 N
        x = rng.standard_normal(sd.shape)
        x = x / np.sqrt(sd.shape[0]) if len(sd.shape) == 2 else 0.1 * x
        return jnp.asarray(x.astype(np.float32))

    jparams = jax.tree.map(fill, shapes)
    if task == "vit":
        x = SI.sample_batch(5, SI.ImageConfig(size=tcfg.image_size),
                            3)["images"].numpy()
    else:
        x = MIMO.sample_batch(5, MIMO.MIMOConfig(), 3)["features"].numpy()
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return task, jcfg, tcfg, jparams, tparams, x


@pytest.mark.parametrize("name", NAMES)
def test_lif_mode_equals_jax(name):
    task, jcfg, tcfg, jparams, tparams, x = _setup(name, "lif")
    sim, backend = JST.AIMCSim(), JE.IntegerBackend()
    fwd = JST.vit_forward if task == "vit" else JST.gpt_forward
    jrng, trng = _key(13)
    causal = task == "gpt"

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
        out = JST._run_blocks(params, s, jcfg, sim, keys[2], causal=causal,
                              backend=backend)
        return s, out, fwd(params, x, jcfg, sim, rng, backend=backend)

    js_in, js_out, jlogits = run(jparams, jnp.asarray(x), jrng)
    jlogits = np.asarray(jlogits)
    assert 0 < float(np.sum(js_out)) < js_out.size * 3
    for backend_name in ("integer", "cuda"):
        eng = XpikeformerEngine.from_config(tcfg, backend=backend_name,
                                            device="cpu")
        eng.params = tparams
        s_out = ST._run_blocks(tparams, _t(js_in), tcfg,
                               prng.split(trng, 4)[2], causal=causal,
                               backend=eng.backend)
        _eq(s_out, js_out, f"{name} lif blocks ({backend_name})")
        logits = eng.forward(_t(x), trng)
        np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0, atol=ATOL)
        _eq(logits.argmax(-1), jlogits.argmax(-1))


@pytest.mark.parametrize("name", NAMES)
def test_ann_mode_equals_jax(name):
    task, jcfg, tcfg, jparams, tparams, x = _setup(name, "ann")
    sim = JST.AIMCSim()
    fwd = JST.vit_forward if task == "vit" else JST.gpt_forward
    jrng, trng = _key(14)
    jlogits = np.asarray(jax.jit(lambda p, x, r: fwd(p, x, jcfg, sim, r))(
        jparams, jnp.asarray(x), jrng))
    got = {}
    for backend_name in ("integer", "cuda"):
        eng = XpikeformerEngine.from_config(tcfg, backend=backend_name,
                                            device="cpu")
        got[backend_name] = eng.forward(_t(x), trng, tparams)
        np.testing.assert_allclose(got[backend_name].numpy(), jlogits,
                                   rtol=0, atol=ATOL)
        label = eng.classify if task == "vit" else eng.detect_symbols
        _eq(label(_t(x), trng, tparams), jlogits.argmax(-1))
    assert torch.equal(got["integer"], got["cuda"])


def test_unknown_mode_raises():
    vcfg = X.SPIKING_ARCHS["xpikeformer-vit-smoke"][1]
    with pytest.raises(ValueError, match="unknown mode"):
        XpikeformerEngine.from_config(dataclasses.replace(vcfg, mode="snn"),
                                      device="cpu")
