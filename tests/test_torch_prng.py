"""The port's threefry twin against ``jax.random``, bit for bit.

Every spike of the port is a comparison against a draw from
:mod:`repro_torch.prng`, so these tests hold each function to the JAX
function it mirrors on fuzzed keys and shapes (numpy seeds, compared as
uint32 words): ``PRNGKey``, ``fold_in``, ``split``, ``random_bits``,
``randint`` (power-of-two spans and not) and ``uniform``, and the draws the
serving path composes from them.  Everything runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spikes as JSP
from repro.kernels import decode_fused as JKFD
from repro.kernels import ops as JKOPS
from repro.models import transformer as JT
from repro.serving import state as JST
from repro_torch import prng
from repro_torch.core import spikes as SP
from repro_torch.kernels import decode_fused as KFD
from repro_torch.kernels import ops as KOPS
from repro_torch.models import transformer as T
from repro_torch.serving import state as ST


def _np(key):
    return np.asarray(key).astype(np.int64)


def _fuzzed_seeds(seed, n):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=n,
                                                dtype=np.uint64)


def test_threefry_runs_partitionable():
    """The twin mirrors the partitionable streams; a change of the JAX
    setting would change every reference draw."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1, 2 ** 32 - 1])
def test_prngkey(seed):
    assert np.array_equal(prng.PRNGKey(seed).numpy(),
                          _np(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("case", range(4))
def test_fold_in_and_split(case):
    seeds = _fuzzed_seeds(case, 3)
    datas = np.random.default_rng(100 + case).integers(0, 2 ** 32, 3,
                                                       dtype=np.uint64)
    for s, d in zip(seeds, datas):
        jk = jax.random.PRNGKey(int(s))
        tk = prng.PRNGKey(int(s))
        assert np.array_equal(prng.fold_in(tk, int(d)).numpy(),
                              _np(jax.random.fold_in(jk, int(d))))
        assert np.array_equal(prng.split(tk, 3).numpy(),
                              _np(jax.random.split(jk, 3)))


def test_fold_in_vectorised_over_keys():
    """A ``[B, 2]`` key tensor with ``[B]`` data is ``vmap(fold_in)``."""
    seeds = _fuzzed_seeds(5, 6).astype(np.uint32)
    pos = np.arange(6, dtype=np.int32) * 37
    base = jnp.stack([jnp.zeros_like(seeds), seeds], -1)
    want = jax.vmap(jax.random.fold_in)(base, pos)
    got = prng.fold_in(prng.key_from_seeds(torch.from_numpy(seeds.astype(np.int64))),
                       torch.from_numpy(pos.astype(np.int64)))
    assert np.array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("shape", [(5,), (3, 4), (2, 3, 33)])
def test_random_bits(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(3), sum(shape))
    want = jax.random.bits(key, shape, jnp.uint32)
    got = prng.random_bits(torch.from_numpy(_np(key)), shape)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("span", [16, 24, 64, 256, 257])
def test_randint(span):
    """JAX's two-word method for every span, power of two or not."""
    for s in _fuzzed_seeds(span, 2):
        key = jax.random.PRNGKey(int(s))
        want = jax.random.randint(key, (4, 50), 0, span, dtype=jnp.int32)
        got = prng.randint(prng.PRNGKey(int(s)), (4, 50), 0, span)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_randint_offset_range():
    key = jax.random.PRNGKey(11)
    want = jax.random.randint(key, (300,), 5, 29, dtype=jnp.int32)
    got = prng.randint(prng.PRNGKey(11), (300,), 5, 29)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(7,), (4, 1, 64)])
def test_uniform(shape):
    for s in _fuzzed_seeds(len(shape), 2):
        key = jax.random.PRNGKey(int(s))
        want = np.asarray(jax.random.uniform(key, shape))
        got = prng.uniform(prng.PRNGKey(int(s)), shape).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_draw_comparator_prns():
    key = jax.random.PRNGKey(42)
    rs, ra = JKOPS.draw_comparator_prns(key, (3, 2, 24), (3, 2, 16), 16, 24)
    trs, tra = KOPS.draw_comparator_prns(prng.PRNGKey(42), (3, 2, 24),
                                         (3, 2, 16), 16, 24)
    assert np.array_equal(trs.numpy(), np.asarray(rs))
    assert np.array_equal(tra.numpy(), np.asarray(ra))


@pytest.mark.parametrize("t,h,l,d,h0", [(2, 3, 24, 16, 0), (4, 2, 40, 64, 2),
                                        (3, 4, 257, 8, 5)])
def test_draw_slot_decode_prns(t, h, l, d, h0):
    """Per-(slot, global head) draws, t-major over ``T*H``, with ``h0``."""
    seeds = _fuzzed_seeds(l, 3).astype(np.uint32)
    keys = jax.vmap(jax.random.PRNGKey)(seeds)
    rs, ra = JKOPS.draw_slot_decode_prns(keys, t, h, l, d, l, h0)
    trs, tra = KOPS.draw_slot_decode_prns(torch.from_numpy(_np(keys)), t, h,
                                          l, d, l, h0)
    assert trs.shape == rs.shape and tra.shape == ra.shape
    assert np.array_equal(trs.numpy(), np.asarray(rs))
    assert np.array_equal(tra.numpy(), np.asarray(ra))


def test_draw_layer_prns_and_rs_at_pos():
    seeds = np.array([3, 9, 27], np.uint32)
    keys = jax.vmap(jax.random.PRNGKey)(seeds)
    rs4, ra4 = JKFD.draw_layer_prns(keys, 4, 2, 24, 16)
    trs4, tra4 = KFD.draw_layer_prns(torch.from_numpy(_np(keys)), 4, 2, 24, 16)
    assert np.array_equal(trs4.numpy(), np.asarray(rs4))
    assert np.array_equal(tra4.numpy(), np.asarray(ra4))
    pos = np.array([0, 23, 24], np.int32)
    want = JKFD._rs_at_pos(rs4, jnp.asarray(pos), jnp.asarray(pos) < 24)
    got = KFD._rs_at_pos(trs4, torch.from_numpy(pos), torch.from_numpy(pos) < 24)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_slot_base_keys():
    seeds = _fuzzed_seeds(8, 5).astype(np.uint32)
    pos = np.array([0, 1, 5, 31, 200], np.int32)
    want = JT._slot_base_keys(jnp.asarray(seeds), jnp.asarray(pos))
    got = T._slot_base_keys(torch.from_numpy(seeds.astype(np.int64)),
                            torch.from_numpy(pos))
    assert np.array_equal(got.numpy(), _np(want))


def test_rate_encode_given_probabilities():
    """Same key, same probabilities -> the same spike trains (``u < p``)."""
    rng = np.random.default_rng(0)
    p = rng.random((3, 1, 40)).astype(np.float32)
    p[0, 0, :4] = [0.0, 1.0, 0.5, 2.0 ** -23]
    seeds = np.array([1, 2, 3], np.uint32)
    keys = jax.vmap(jax.random.PRNGKey)(seeds)
    want = jax.vmap(lambda k, x: JSP.rate_encode(k, x, 4), out_axes=1)(
        keys, jnp.asarray(p))
    got = SP.rate_encode(torch.from_numpy(_np(keys)), torch.from_numpy(p), 4)
    assert np.array_equal(got.movedim(1, 0).numpy(), np.asarray(want))


def test_content_keys():
    toks = np.random.default_rng(1).integers(0, 300, 40)
    assert np.array_equal(ST.content_keys(toks), JST.content_keys(toks))
