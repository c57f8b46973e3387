"""The float LM stack's layers and mixers in the port against the JAX package.

Every case draws its inputs and weights with numpy from a seed, runs the
JAX function (``repro.models.layers``, ``ssm``, ``rglru``, ``frontends``)
and its port (``repro_torch.models``) on the same values on the CPU, and
holds them within ``ATOL``: ``exp``, ``sigmoid``, ``sin``/``cos`` and
``pow`` are float boundaries against XLA, XLA's CPU fusions contract
``a * b + c``, and the port's einsums sum in other orders.  The decode
cases run several steps from one cache and hold the caches too (the
port's decode updates its cache in place).  The JAX references are
lowered and compiled in a pool of threads (the ``refs`` fixture: XLA
compiles in parallel).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import frontends as JF
from repro.models import layers as JL
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.models import frontends as F
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S

# float32 values of order one through a few products and transcendentals
ATOL = 1e-5
# the RG-LRU's scan: JAX's associative_scan and the port's log-depth scan
# combine the same pairs in other trees
SCAN_ATOL = 2e-5

ATTN = dict(name="t", family="dense", num_layers=1, d_model=32, num_heads=4,
            num_kv_heads=2, head_dim=8, d_ff=48, vocab_size=64,
            dtype="float32")
SSD = dict(name="t", family="ssm", num_layers=1, d_model=32, num_heads=0,
           num_kv_heads=0, d_ff=0, vocab_size=64, block_pattern=("ssd",),
           ssm_state_dim=16, ssm_head_dim=16, ssm_expand=2, ssm_n_groups=2,
           ssm_chunk=8, dtype="float32")
LRU = dict(name="t", family="hybrid", num_layers=1, d_model=32, num_heads=2,
           num_kv_heads=1, d_ff=64, vocab_size=64, block_pattern=("rglru",),
           rglru_width=24, dtype="float32")


def _cfgs(base, **change):
    kw = {**base, **change}
    return JModelConfig(**kw), ModelConfig(**kw)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _params(rng, schema, scale=0.3):
    """numpy weights for a ``name -> (shape, init)`` schema (normal leaves
    scaled, ``ones`` leaves perturbed around one so they matter)."""
    out = {}
    for name, (shape, init) in schema.items():
        if init == "normal":
            out[name] = _rand(rng, *shape, scale=scale)
        elif init == "ones":
            out[name] = (1.0 + 0.1 * _rand(rng, *shape)).astype(np.float32)
        else:
            out[name] = 0.1 * _rand(rng, *shape)
    return out


def _pair(tree):
    """numpy tree -> (JAX tree, torch tree)."""
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a, copy=True)),
                         tree))


def _close(got, want, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol, err_msg=what)


def _attn_params(rng, cfg, qkv_bias=False):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": _rand(rng, d, h, hd, scale=0.3),
         "wk": _rand(rng, d, kv, hd, scale=0.3),
         "wv": _rand(rng, d, kv, hd, scale=0.3),
         "wo": _rand(rng, h, hd, d, scale=0.3)}
    if qkv_bias:
        p.update(bq=_rand(rng, h, hd, scale=0.1), bk=_rand(rng, kv, hd, scale=0.1),
                 bv=_rand(rng, kv, hd, scale=0.1))
    return p


# ---------------------------------------------------------------------------
# Cases: each builds its inputs from a seed and returns the JAX function,
# its arguments and what the test needs besides
# ---------------------------------------------------------------------------


def _rope_case(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    return (lambda a, b: JL.apply_rope(a, b, theta)), (x, pos)


def _sdpa_case(softcap, masked):
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 2, 6, 8, 8), _rand(rng, 2, 9, 2, 8), _rand(rng, 2, 9, 2, 8)
    mask = rng.random((2, 1, 1, 6, 9)) < 0.7 if masked else None
    return (lambda *a: JL._sdpa(*a, softcap)), (q, k, v, mask)


def _flash_case(window, softcap):
    rng = np.random.default_rng(3)
    qkv = (_rand(rng, 2, 32, 4, 8), _rand(rng, 2, 32, 2, 8),
           _rand(rng, 2, 32, 2, 8))
    return (lambda *a: JL._flash_attention(*a, softcap, window=window,
                                           blk=8)), qkv


def _banded_case(s):
    jcfg, _ = _cfgs(ATTN, window_size=8)
    rng = np.random.default_rng(4)
    qkv = (_rand(rng, 2, s, 4, 8), _rand(rng, 2, s, 2, 8),
           _rand(rng, 2, s, 2, 8))
    return (lambda *a: JL._banded_local(*a, jcfg, 8)), qkv


def _attention_case(s, window, qkv_bias):
    jcfg, tcfg = _cfgs(ATTN, qkv_bias=qkv_bias, window_size=max(window, 1))
    rng = np.random.default_rng(5)
    p = _attn_params(rng, tcfg, qkv_bias)
    x = _rand(rng, 2, s, 32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    return (lambda *a: JL.attention(*a, jcfg, window=window)), (p, x, pos)


def _attention_decode_case(window):
    jcfg, _ = _cfgs(ATTN, window_size=max(window, 1))
    rng = np.random.default_rng(6)
    p = _attn_params(rng, jcfg)
    rows = window or 16
    cache = {"k": _rand(rng, 3, rows, 2, 8), "v": _rand(rng, 3, rows, 2, 8),
             "pos": np.array([0, 3, 5], np.int32)}
    xs = [_rand(rng, 3, 1, 32) for _ in range(10)]
    return ((lambda *a: JL.attention_decode(*a, jcfg, window=window)),
            (p, xs[0], cache), xs)


def _mlp_case(act, gated):
    jcfg, _ = _cfgs(ATTN, act=act, gated_mlp=gated)
    rng = np.random.default_rng(7)
    p = {"wi": _rand(rng, 32, 48, scale=0.3), "wo": _rand(rng, 48, 32, scale=0.3)}
    if gated:
        p["wg"] = _rand(rng, 32, 48, scale=0.3)
    return (lambda *a: JL.mlp(*a, jcfg)), (p, _rand(rng, 2, 5, 32))


def _ssd_params(rng, cfg):
    p = _params(rng, S.ssd_schema(cfg))
    p["a_log"] = (0.5 * _rand(rng, *p["a_log"].shape)).astype(np.float32)
    return p


def _ssd_case(L_):
    jcfg, tcfg = _cfgs(SSD)
    rng = np.random.default_rng(8)
    return ((lambda *a: JS.ssd_mixer(*a, jcfg)),
            (_ssd_params(rng, tcfg), _rand(rng, 2, L_, 32)))


def _ssd_decode_case():
    jcfg, tcfg = _cfgs(SSD)
    rng = np.random.default_rng(9)
    p = _ssd_params(rng, tcfg)
    shapes = {k: (v.shape, v.dtype) for k, v in
              JS.ssd_cache_schema(jcfg, 3).items()}
    cache = {k: (_rand(rng, *s, scale=0.3) if d == jnp.float32
                 else np.array([0, 2, 7], np.int32))
             for k, (s, d) in shapes.items()}
    xs = [_rand(rng, 3, 1, 32) for _ in range(6)]
    return (lambda *a: JS.ssd_decode(*a, jcfg)), (p, xs[0], cache), xs


def _rglru_case(L_):
    jcfg, tcfg = _cfgs(LRU)
    rng = np.random.default_rng(10)
    return ((lambda *a: JR.rglru_mixer(*a, jcfg)),
            (_params(rng, R.rglru_schema(tcfg)), _rand(rng, 2, L_, 32)))


def _rglru_decode_case():
    jcfg, tcfg = _cfgs(LRU)
    rng = np.random.default_rng(11)
    p = _params(rng, R.rglru_schema(tcfg))
    cache = {"h": _rand(rng, 3, 24), "conv": _rand(rng, 3, 3, 24, scale=0.3),
             "pos": np.array([1, 4, 0], np.int32)}
    xs = [_rand(rng, 3, 1, 32) for _ in range(6)]
    return (lambda *a: JR.rglru_decode(*a, jcfg)), (p, xs[0], cache), xs


def _frontend_case():
    jcfg, _ = _cfgs(ATTN, frontend="audio_frames", frontend_dim=12)
    return ((lambda k: JF.synth_frontend_batch(k, jcfg, 3, 7)),
            (jax.random.PRNGKey(5),))


ROPE = [1e4, 1e6]
SDPA = [(0.0, True), (5.0, True), (0.0, False)]
FLASH = [(0, 0.0), (0, 4.0), (12, 0.0)]
BANDED = [24, 40]
ATTENTION = [(12, 0, False), (12, 0, True), (16, 4, False), (12, 4, True)]
WINDOWS = [0, 4]
MLP = [("silu", True), ("gelu", True), ("gelu", False), ("silu", False)]
SSD_LENGTHS = [8, 24]
LRU_LENGTHS = [1, 33]


def _cases():
    out = {("rope", t): _rope_case(t) for t in ROPE}
    out.update({("sdpa",) + c: _sdpa_case(*c) for c in SDPA})
    out.update({("flash",) + c: _flash_case(*c) for c in FLASH})
    out.update({("banded", s): _banded_case(s) for s in BANDED})
    out.update({("attention",) + c: _attention_case(*c) for c in ATTENTION})
    out.update({("attention_decode", w): _attention_decode_case(w)
                for w in WINDOWS})
    out.update({("mlp",) + c: _mlp_case(*c) for c in MLP})
    out.update({("ssd", n): _ssd_case(n) for n in SSD_LENGTHS})
    out["ssd_decode"] = _ssd_decode_case()
    out.update({("rglru", n): _rglru_case(n) for n in LRU_LENGTHS})
    out["rglru_decode"] = _rglru_decode_case()
    out["frontend"] = _frontend_case()
    return out


def _compile(fn, args):
    return jax.jit(fn).lower(*args).compile()


@pytest.fixture(scope="module")
def refs():
    """Every case's JAX function, lowered on its arguments and compiled,
    in a pool of threads (XLA compiles in parallel)."""
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex:
        futures = {k: ex.submit(_compile, c[0], c[1])
                   for k, c in _cases().items()}
        return {k: f.result() for k, f in futures.items()}


def _t(*xs):
    return [None if x is None else torch.from_numpy(np.array(x, copy=True))
            for x in xs]


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta", ROPE)
def test_rope(refs, theta):
    """Positions below 300 (a serve's cache lengths): past a few thousand
    radians XLA's fused ``sin``/``cos`` drift from torch's by ~5e-5."""
    _, (x, pos) = _rope_case(theta)
    _close(L.rope_frequencies(16, theta), JL.rope_frequencies(16, theta))
    _close(L.apply_rope(*_t(x, pos), theta), refs["rope", theta](x, pos))


@pytest.mark.parametrize("softcap,masked", SDPA)
def test_sdpa_gqa(refs, softcap, masked):
    """Grouped attention (8 query heads over 2 KV heads), the softcap and
    the ``-1e30`` fill, the softmax in float32."""
    _, args = _sdpa_case(softcap, masked)
    _close(L._sdpa(*_t(*args), softcap), refs["sdpa", softcap, masked](*args))


@pytest.mark.parametrize("s,window", [(8, 0), (13, 5)])
def test_masks(s, window):
    if window:
        got = L.window_mask(s, s + 3, window, offset=2)
        want = JL.window_mask(s, s + 3, window, offset=2)
    else:
        got, want = L.causal_mask(s, s + 3, 2), JL.causal_mask(s, s + 3, 2)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window,softcap", FLASH)
def test_flash_attention(refs, window, softcap):
    """The online-softmax loop over KV blocks of 8 (s = 32: four blocks),
    global and windowed; also against the masked attention it replaces."""
    _, qkv = _flash_case(window, softcap)
    got = L._flash_attention(*_t(*qkv), softcap, window=window, blk=8)
    _close(got, refs["flash", window, softcap](*qkv))
    m = (L.window_mask(32, 32, window) if window else L.causal_mask(32, 32))
    _close(got, L._sdpa(*_t(*qkv), m[None, None, None], softcap))


@pytest.mark.parametrize("s", BANDED)
def test_banded_local(refs, s):
    """The Q-block loop of a sliding window of 8 (s > 2 windows)."""
    _, tcfg = _cfgs(ATTN, window_size=8)
    _, qkv = _banded_case(s)
    _close(L._banded_local(*_t(*qkv), tcfg, 8), refs["banded", s](*qkv))


@pytest.mark.parametrize("s,window,qkv_bias", ATTENTION)
def test_attention_dispatch(refs, s, window, qkv_bias):
    """``attention``: the masked einsum (s = 12), and the banded loop for a
    window of 4 at s = 16; with and without ``qkv_bias``."""
    _, tcfg = _cfgs(ATTN, qkv_bias=qkv_bias, window_size=max(window, 1))
    _, (p, x, pos) = _attention_case(s, window, qkv_bias)
    got = L.attention(_pair(p)[1], *_t(x, pos), tcfg, window=window)
    _close(got, refs["attention", s, window, qkv_bias](p, x, pos))


def _decode_steps(step, port_step, p, cache, xs, names):
    """Run the JAX and port decode steps from one cache over the inputs
    ``xs``; every output and the caches' ``names`` leaves close, ``pos``
    equal."""
    jp, tp = _pair(p)
    jc, tc = _pair(cache)
    for i, x in enumerate(xs):
        want, jc = step(jp, x, jc)
        got, tc = port_step(tp, torch.from_numpy(x), tc)
        _close(got, want, what=f"step {i}")
        for name in names:
            _close(tc[name], jc[name], what=f"step {i} cache {name}")
        assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("window", WINDOWS)
def test_attention_decode(refs, window):
    """Ten decode steps from a cache of 6 positions, slots at different
    positions; a window of 4 makes the cache a ring buffer of 4 rows that
    every slot wraps."""
    jcfg, tcfg = _cfgs(ATTN, window_size=max(window, 1))
    _, (p, _, cache), xs = _attention_decode_case(window)
    _decode_steps(refs["attention_decode", window],
                  lambda *a: L.attention_decode(*a, tcfg, window=window),
                  p, cache, xs, ("k", "v"))
    cs = L.attention_cache(tcfg, 3, 16, "cpu", window=window, lead=(2,))
    js = JL.attention_cache_schema(jcfg, 3, 16, window=window)
    assert {k: tuple(v.shape[1:]) for k, v in cs.items()} == {
        k: tuple(v.shape) for k, v in js.items()}


@pytest.mark.parametrize("act,gated", MLP)
def test_mlp(refs, act, gated):
    """``jax.nn.gelu`` is the tanh approximation; ``gated_mlp`` adds
    ``wg``."""
    _, tcfg = _cfgs(ATTN, act=act, gated_mlp=gated)
    _, (p, x) = _mlp_case(act, gated)
    _close(L.mlp(_pair(p)[1], *_t(x), tcfg), refs["mlp", act, gated](p, x))


@pytest.mark.parametrize("L_", SSD_LENGTHS)
def test_ssd_mixer(refs, L_):
    """The chunked SSD (chunks of 8: one, then three) with two B/C
    groups."""
    _, tcfg = _cfgs(SSD)
    _, (p, x) = _ssd_case(L_)
    _close(S.ssd_mixer(_pair(p)[1], *_t(x), tcfg), refs["ssd", L_](p, x))


def test_ssd_decode(refs):
    """Six decode steps from a random state and convolution history."""
    jcfg, tcfg = _cfgs(SSD)
    _, (p, _, cache), xs = _ssd_decode_case()
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in
            S.ssd_cache(tcfg, 3, "cpu").items()} == {
        k: (tuple(v.shape), str(np.dtype(v.dtype))) for k, v in
        JS.ssd_cache_schema(jcfg, 3).items()}
    _decode_steps(refs["ssd_decode"],
                  lambda *a: S.ssd_decode(*a, tcfg), p, cache, xs,
                  ("ssd", "conv_x", "conv_bc"))


@pytest.mark.parametrize("L_", LRU_LENGTHS)
def test_rglru_mixer(refs, L_):
    """The RG-LRU block over 1 and 33 steps (the log-depth scan's partial
    last level)."""
    _, tcfg = _cfgs(LRU)
    _, (p, x) = _rglru_case(L_)
    _close(R.rglru_mixer(_pair(p)[1], *_t(x), tcfg), refs["rglru", L_](p, x),
           atol=SCAN_ATOL)


def test_linear_scan_is_the_recurrence():
    """The log-depth scan against the step loop, in float64 (the same
    values up to the summation order)."""
    g = torch.Generator().manual_seed(0)
    a = torch.rand((3, 21, 5), generator=g, dtype=torch.float64)
    b = torch.randn((3, 21, 5), generator=g, dtype=torch.float64)
    h, want = torch.zeros(3, 5, dtype=torch.float64), []
    for t in range(21):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = R.linear_scan(a, b)
    assert float((got - torch.stack(want, 1)).abs().max()) < 1e-12


def test_rglru_decode(refs):
    """Six decode steps from a random state (``h`` float32) and history."""
    _, tcfg = _cfgs(LRU)
    _, (p, _, cache), xs = _rglru_decode_case()
    _decode_steps(refs["rglru_decode"],
                  lambda *a: R.rglru_decode(*a, tcfg), p, cache, xs,
                  ("h", "conv"))


def test_synth_frontend_batch(refs):
    """The stub frontend's batch from one key: the targets bit for bit,
    the embeddings to ``erfinv``'s last bits."""
    _, tcfg = _cfgs(ATTN, frontend="audio_frames", frontend_dim=12)
    want = refs["frontend"](jax.random.PRNGKey(5))
    got = F.synth_frontend_batch(prng.PRNGKey(5), tcfg, 3, 7)
    assert np.array_equal(got["targets"].numpy(), np.asarray(want["targets"]))
    _close(got["embeddings"], want["embeddings"])
    assert F.frontend_feature_dim(tcfg) == 12

