"""The three ported kernels' plain versions against the JAX reference.

K1 ``aimc_spiking_linear``, K2 ``ssa_decode`` and K3 ``fused_decode_layer``
run here on the CPU, where every wrapper takes its plain PyTorch version.
Each is held **exactly** equal to its oracle in ``repro.kernels.ref`` on
inputs made with numpy, including membranes that land exactly on the LIF
threshold (dyadic scales and biases), padding shapes (``hd=16``, ``L=24``),
GQA and masked writes.  K2's and K3's wrappers are also held against the
JAX wrappers that run the Pallas kernels in interpret mode, and the
backends against ``repro.engine.IntegerBackend``.

``tests/test_torch_gpu.py`` holds each CUDA kernel against these plain
versions on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import aimc_device as JAD
from repro import engine as JE
from repro.kernels import decode_fused as JKFD
from repro.kernels import ops as JKOPS
from repro.kernels import ref as JREF
from repro.kernels.plan import AttnSpec as JAttnSpec
from repro.kernels.plan import KVView as JKVView
from repro_torch import aimc_device as AD
from repro_torch import engine as E
from repro_torch.kernels import aimc_matmul as KA
from repro_torch.kernels import decode_fused as KFD
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels import ref as KREF
from repro_torch.kernels import ssa_attention as KS
from repro_torch.kernels.plan import AttnSpec, KVView


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _eq(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want.astype(got.dtype)), (
        f"{np.sum(got != want)} of {got.size} elements differ")


def _triple(rng, d_in, d_out, *, dyadic, bias=True):
    """int8 levels in [-15, 15], f32 scale and bias.  Dyadic scales and
    biases (multiples of 1/8) put many membranes exactly on the
    threshold, where a stray FMA or a fused rounding would flip a spike."""
    lv = rng.integers(-15, 16, (d_in, d_out)).astype(np.int8)
    if dyadic:
        sc = (rng.integers(1, 4, d_out) / 8.0).astype(np.float32)
        bi = (rng.integers(-4, 9, d_out) / 8.0).astype(np.float32)
    else:
        sc = (rng.random(d_out) * 0.2 + 0.01).astype(np.float32)
        bi = (rng.standard_normal(d_out) * 0.5).astype(np.float32)
    return lv, sc, (bi if bias else None)


def _jw(w):
    return None if w is None else tuple(None if x is None else jnp.asarray(x)
                                        for x in w)


def _tw(w):
    return None if w is None else tuple(None if x is None else _t(x) for x in w)


# ---------------------------------------------------------------------------
# Quantisation and bit packing
# ---------------------------------------------------------------------------


def test_quantize_weights_matches_reference():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, 48, 40)).astype(np.float32) * 0.3
    w[1, :, 5] = 0.0  # an all-zero column takes scale 1
    w[0, 3, 7] = 0.5 * np.abs(w[0, :, 7]).max()  # halves round to even
    lv, sc = JAD.quantize_weights(jnp.asarray(w), JAD.AIMCConfig())
    tlv, tsc = AD.quantize_weights(_t(w))
    _eq(tsc, sc)
    _eq(tlv, lv)


def test_pack_unpack_bits_match_reference():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2, (3, 64, 5)).astype(np.uint8)
    want = JKOPS.pack_bits(jnp.asarray(x), axis=1)
    got = KOPS.pack_bits(_t(x), dim=1)
    _eq(got, np.asarray(want).astype(np.int64))
    _eq(KOPS.unpack_bits(got, 60, dim=1), JKOPS.unpack_bits(want, 60, axis=1))


# ---------------------------------------------------------------------------
# K1: spiking linear
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,m,d_in,d_out,dyadic,bias", [
    (4, 1, 64, 48, True, True),
    (4, 5, 64, 128, True, False),
    (3, 2, 130, 70, False, True),
    (4, 8, 256, 64, False, False),
])
def test_spiking_linear_plain_exact(t, m, d_in, d_out, dyadic, bias):
    rng = np.random.default_rng(d_in + d_out)
    # integer-valued inputs: the residual stream carries counts above one
    x = rng.integers(0, 4, (t, m, d_in)).astype(np.float32)
    lv, sc, bi = _triple(rng, d_in, d_out, dyadic=dyadic, bias=bias)
    want = JREF.aimc_spiking_linear_ref(jnp.asarray(x), jnp.asarray(lv),
                                        jnp.asarray(sc), _jw((bi,))[0])
    got = KA.aimc_spiking_linear_kernel(_t(x), _t(lv), _t(sc),
                                        None if bi is None else _t(bi))
    _eq(got, want)
    assert got.dtype == torch.uint8
    _eq(KOPS.aimc_spiking_linear(_t(x), _t(lv), _t(sc),
                                 None if bi is None else _t(bi)), want)


def test_spiking_linear_threshold_ties():
    """Membranes sitting exactly on v_thresh fire (``v >= 1``)."""
    x = np.ones((2, 1, 2), np.float32)
    lv = np.array([[1, 1], [1, 0]], np.int8)
    sc = np.array([0.5, 0.5], np.float32)
    bi = np.array([0.0, 0.25], np.float32)
    want = JREF.aimc_spiking_linear_ref(*(jnp.asarray(a) for a in (x, lv, sc, bi)))
    got = KREF.aimc_spiking_linear_ref(*(_t(a) for a in (x, lv, sc, bi)))
    _eq(got, want)
    assert got[0, 0, 0] == 1  # 1.0 >= 1.0


@pytest.mark.parametrize("backend", ["integer", "cuda"])
def test_backend_spiking_linear_matches_integer(backend):
    """Float weights quantise inside the backend, as in the reference."""
    rng = np.random.default_rng(3)
    s = rng.integers(0, 2, (4, 2, 1, 64)).astype(np.float32)
    w = rng.standard_normal((64, 96)).astype(np.float32) / 8
    b = rng.standard_normal(96).astype(np.float32) * 0.1
    want = JE.IntegerBackend().spiking_linear(
        None, {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(s))
    got = E.get_backend(backend).spiking_linear({"w": _t(w), "b": _t(b)}, _t(s))
    _eq(got, want)


# ---------------------------------------------------------------------------
# K2: SSA decode row
# ---------------------------------------------------------------------------


def _decode_inputs(rng, g, l, d, fill):
    q = rng.integers(0, 2, (g, 1, d)).astype(np.uint8)
    k = (rng.random((g, l, d)) < fill).astype(np.uint8)
    v = (rng.random((g, l, d)) < fill).astype(np.uint8)
    k[:, l // 2:] = 0  # unwritten positions
    v[:, l // 2:] = 0
    rs = rng.integers(0, d, (g, 1, l)).astype(np.int32)
    ra = rng.integers(0, l, (g, 1, d)).astype(np.int32)
    return q, k, v, rs, ra


@pytest.mark.parametrize("g,l,d", [(6, 24, 16), (4, 256, 64), (3, 33, 40)])
def test_ssa_decode_plain_exact(g, l, d):
    rng = np.random.default_rng(l * d)
    args = _decode_inputs(rng, g, l, d, 0.6)
    want = JREF.ssa_decode_ref(*(jnp.asarray(a) for a in args))
    got = KS.ssa_decode_kernel(*(_t(a) for a in args))
    _eq(got, want)
    assert got.dtype == torch.uint8 and int(got.sum()) > 0


@pytest.mark.parametrize("t,b,h,l,d,h0", [(2, 2, 2, 24, 16, 0),
                                          (2, 1, 2, 32, 64, 3)])
def test_ssa_decode_wrapper_matches_pallas_interpret(t, b, h, l, d, h0):
    """Layouts, padding and draws of the wrapper: equal to the reference
    wrapper running the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(l + d)
    q = rng.integers(0, 2, (t, b, h, 1, d)).astype(np.uint8)
    k = (rng.random((t, b, h, l, d)) < 0.5).astype(np.uint8)
    v = (rng.random((t, b, h, l, d)) < 0.5).astype(np.uint8)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(b, dtype=jnp.uint32) + 9)
    want = JKOPS.ssa_attention_decode_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), keys, h0, i_max=l,
        interpret=True)
    tkeys = _t(np.asarray(keys).astype(np.int64))
    got = KOPS.ssa_attention_decode_packed(_t(q), _t(k), _t(v), tkeys, h0,
                                           i_max=l)
    _eq(got, want)


@pytest.mark.parametrize("backend", ["integer", "cuda"])
def test_backend_decode_attention_matches_integer(backend):
    rng = np.random.default_rng(5)
    t, b, h, l, d = 4, 3, 4, 24, 16
    q = rng.integers(0, 2, (t, b, h, 1, d)).astype(np.uint8)
    k = (rng.random((t, b, h, l, d)) < 0.5).astype(np.uint8)
    v = (rng.random((t, b, h, l, d)) < 0.5).astype(np.uint8)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(b, dtype=jnp.uint32))
    want = JE.IntegerBackend().decode_attention(
        JKVView.dense(jnp.asarray(k), jnp.asarray(v)), jnp.asarray(q),
        JAttnSpec(i_max=l), slot_keys=keys)
    got = E.get_backend(backend).decode_attention(
        KVView.dense(_t(k), _t(v)), _t(q), AttnSpec(i_max=l),
        slot_keys=_t(np.asarray(keys).astype(np.int64)))
    _eq(got, want)


KEYED_CASES = {
    # name: (t, b, h, l, d, h0, i_max, pos): each slot's live length pos[b]
    # (its cache rows at and past it are zero)
    "prefill": (4, 1, 4, 256, 64, 0, 256, [37]),
    "slots": (2, 3, 2, 40, 16, 0, 40, [0, 17, 40]),
    "h0": (2, 2, 2, 24, 16, 2, 24, [5, 24]),
    "i_max": (3, 2, 2, 32, 32, 1, 20, [10, 31]),
    "ragged": (2, 3, 3, 33, 40, 3, 33, [1, 33, 20]),
}


@pytest.mark.parametrize("case", sorted(KEYED_CASES))
def test_keyed_decode_row_matches_pallas_interpret(case):
    """The SSA decode row that draws its own comparators, on the CPU (its
    plain version: the threefry twin, then ``ssa_decode_ref``), fed the
    cache as the serving path holds it (a permuted ``[B,T,L,H,D]`` view)
    with each slot's ``pos``: equal to the reference wrapper running the
    Pallas kernel in interpret mode, over distinct slot keys, ``h0 != 0``,
    ``i_max != L`` and widths that are not multiples of 32."""
    t, b, h, l, d, h0, i_max, pos = KEYED_CASES[case]
    rng = np.random.default_rng(l * d + b)
    q = rng.integers(0, 2, (t, b, h, 1, d)).astype(np.uint8)
    sk = (rng.random((b, t, l, h, d)) < 0.5).astype(np.uint8)
    sv = (rng.random((b, t, l, h, d)) < 0.5).astype(np.uint8)
    for i, p in enumerate(pos):
        sk[i, :, p:] = 0
        sv[i, :, p:] = 0
    k, v = (x.transpose(1, 0, 3, 2, 4) for x in (sk, sv))
    seeds = np.random.default_rng(b + h0).integers(0, 2 ** 32, b,
                                                   dtype=np.uint64)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds.astype(np.uint32)))
    want = JKOPS.ssa_attention_decode_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), keys, h0,
        i_max=i_max, interpret=True)
    tkeys = _t(np.asarray(keys).astype(np.int64))
    kf, vf = (_t(x).permute(1, 0, 3, 2, 4) for x in (sk, sv))
    got = KOPS.ssa_attention_decode_packed(
        _t(q), kf, vf, tkeys, h0, i_max=i_max, pos=_t(np.int32(pos)))
    _eq(got, want)
    assert int(got.sum()) > 0
    _eq(KREF.ssa_decode_keyed_ref(_t(q), kf, vf, tkeys, h0, i_max=i_max),
        want)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", [(4, 4, 256), (4, 1, 256), (3, 5, 33)])
def test_lif_counts_plain_exact(shape, bias):
    """The row-parallel epilogue's plain version (``counts * scale``, ``+
    bias``, LIF) and its wrappers on the CPU == the reference's
    ``lif_ref(counts * scale + b)``; dyadic scales and biases put
    membranes exactly on the threshold."""
    t, m, n = shape
    rng = np.random.default_rng(sum(shape) + bias)
    counts = rng.integers(-40, 41, shape).astype(np.float32)
    scale = (rng.integers(1, 4, n) / 32.0).astype(np.float32)
    b = (rng.integers(-4, 9, n) / 8.0).astype(np.float32) if bias else None
    pre = jnp.asarray(counts) * jnp.asarray(scale)
    if bias:
        pre = pre + jnp.asarray(b)
    assert bool(jnp.any(pre[0] == 1.0))  # membranes on the threshold
    want = np.asarray(JREF.lif_ref(pre.reshape(t, -1))).reshape(shape)
    args = (_t(counts), _t(scale), None if b is None else _t(b))
    _eq(KREF.lif_counts_ref(*args), want)
    _eq(KOPS.lif_counts_fused(*args), want)
    for name in ("integer", "cuda"):
        _eq(E.get_backend(name).counts_lif(*args), want)


# ---------------------------------------------------------------------------
# K3: fused decoder layer
# ---------------------------------------------------------------------------


def _layer_inputs(rng, *, t, b, d, h, kv, hd, l, dff, pos, dyadic=True):
    s = rng.integers(0, 3, (t, b, d)).astype(np.float32)
    sk = (rng.random((b, t, l, kv, hd)) < 0.5).astype(np.uint8)
    sv = (rng.random((b, t, l, kv, hd)) < 0.5).astype(np.uint8)
    for i, p in enumerate(pos):  # the serving invariant: rows >= pos are 0
        sk[i, :, p:] = 0
        sv[i, :, p:] = 0
    ws = [_triple(rng, d, h * hd, dyadic=dyadic),
          _triple(rng, d, kv * hd, dyadic=dyadic, bias=False),
          _triple(rng, d, kv * hd, dyadic=dyadic),
          _triple(rng, h * hd, d, dyadic=dyadic),
          _triple(rng, d, dff, dyadic=dyadic),
          _triple(rng, dff, d, dyadic=dyadic, bias=False)]
    return s, sk, sv, np.asarray(pos, np.int32), ws


LAYER_CASES = {
    # name: (t, b, d, h, kv, hd, l, dff, pos, with_tail, with_mlp)
    "padding": (4, 3, 64, 4, 4, 16, 24, 128, [0, 9, 23], True, True),
    "gqa": (4, 2, 64, 4, 2, 16, 32, 96, [5, 31], True, True),
    "masked_write": (2, 3, 48, 2, 2, 16, 24, 64, [24, 3, 30], True, True),
    "no_mlp": (3, 2, 64, 2, 1, 32, 40, 64, [1, 39], True, False),
    "no_tail": (4, 2, 64, 4, 4, 16, 24, 128, [7, 0], False, True),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_decode_layer_plain_exact(case):
    t, b, d, h, kv, hd, l, dff, pos, tail, mlp = LAYER_CASES[case]
    rng = np.random.default_rng(len(case))
    s, sk, sv, pos, ws = _layer_inputs(rng, t=t, b=b, d=d, h=h, kv=kv, hd=hd,
                                       l=l, dff=dff, pos=pos)
    rs = rng.integers(0, hd, (b, t, h, l)).astype(np.int32)
    ra = rng.integers(0, l, (b, t, h, hd)).astype(np.int32)
    want = jax.jit(JREF.decode_layer_ref,
                   static_argnames=("hd", "with_tail", "with_mlp"))(
        jnp.asarray(s), jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(pos),
        *(_jw(w) for w in ws), jnp.asarray(rs), jnp.asarray(ra), hd=hd,
        with_tail=tail, with_mlp=mlp)
    got = KREF.decode_layer_ref(
        _t(s), _t(sk), _t(sv), _t(pos), *(_tw(w) for w in ws), _t(rs), _t(ra),
        hd=hd, with_tail=tail, with_mlp=mlp)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("case", ["padding", "gqa", "masked_write"])
def test_fused_layer_wrapper_matches_pallas_interpret(case):
    """Draws, the new-token draw at ``pos`` and the pre-scatter contract:
    the port's wrapper equals the reference megakernel in interpret mode."""
    t, b, d, h, kv, hd, l, dff, pos, tail, mlp = LAYER_CASES[case]
    rng = np.random.default_rng(100 + len(case))
    s, sk, sv, pos, ws = _layer_inputs(rng, t=t, b=b, d=d, h=h, kv=kv, hd=hd,
                                       l=l, dff=dff, pos=pos, dyadic=False)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(b, dtype=jnp.uint32) + 4)
    want = JKFD.fused_decode_layer(
        keys, jnp.asarray(s), jnp.asarray(sk), jnp.asarray(sv),
        jnp.asarray(pos), *(_jw(w) for w in ws), hd=hd, interpret=True)
    got = KFD.fused_decode_layer(
        _t(np.asarray(keys).astype(np.int64)), _t(s), _t(sk), _t(sv), _t(pos),
        *(_tw(w) for w in ws), hd=hd)
    for g, w in zip(got, want):
        _eq(g, w)


@functools.cache
def _fused_layer_reference():
    """Inputs with float weights, and the JAX integer backend's output."""
    rng = np.random.default_rng(8)
    t, b, d, h, kv, hd, l, dff = 4, 2, 64, 4, 4, 16, 24, 128
    s = rng.integers(0, 2, (t, b, d)).astype(np.float32)
    sk = (rng.random((b, t, l, kv, hd)) < 0.5).astype(np.uint8)
    sv = (rng.random((b, t, l, kv, hd)) < 0.5).astype(np.uint8)
    pos = np.array([4, 11], np.int32)
    for i, p in enumerate(pos):
        sk[i, :, p:] = 0
        sv[i, :, p:] = 0
    shapes = [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d), (d, dff),
              (dff, d)]
    ws = [rng.standard_normal(sh).astype(np.float32) / np.sqrt(sh[0])
          for sh in shapes]
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(b, dtype=jnp.uint32))
    want = jax.jit(lambda k, s, sk, sv, pos, *ws: JE.IntegerBackend()
                   .decode_layer_fused(k, s, JKVView.dense(sk, sv), pos, *ws,
                                       hd=hd))(
        keys, *(jnp.asarray(a) for a in (s, sk, sv, pos, *ws)))
    return keys, s, sk, sv, pos, ws, hd, [np.asarray(w) for w in want]


@pytest.mark.parametrize("backend", ["integer", "cuda"])
def test_backend_decode_layer_fused_matches_integer(backend):
    """Float weights through the backends' fused-layer surface."""
    keys, s, sk, sv, pos, ws, hd, want = _fused_layer_reference()
    got = E.get_backend(backend).decode_layer_fused(
        _t(np.asarray(keys).astype(np.int64)), _t(s),
        KVView.dense(_t(sk), _t(sv)), _t(pos), *(_t(w) for w in ws), hd=hd)
    for g, w in zip(got, want):
        _eq(g, w)
