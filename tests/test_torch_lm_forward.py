"""The LM stack's full-sequence forward in the port against the JAX package.

On the reduced ``xpikeformer-gpt-4-256`` (2 layers, ``d=64``, 4 heads of
16, vocab 257), with JAX's weights carried over through numpy, on the CPU
(every kernel wrapper takes its plain version), both port backends
(``integer``, and ``cuda`` through its plain versions):

* given JAX's rate-encoded input, the spike trains out of every block
  equal JAX's ``IntegerBackend``'s bit for bit, and the port's key chain
  gives each block JAX's key;
* ``forward``'s logits and ``loss_fn``'s loss and cross-entropy agree
  within ``ATOL`` (the embed's scale, the rate-coding sigmoid and the
  final layernorm and unembed are the float boundary);
* ``prefill`` equals the port's ``forward`` (the reference's ``prefill``
  gives a spiking config no rng and fails; it is held to JAX's
  ``forward``), ``engine.forward(task="lm")`` too, and with
  ``metering=True`` its report equals JAX's ``MeteringBackend``'s counts;
* a GQA config (2 KV heads), ``attention_kind="lif"`` (the LIF attention),
  a pattern with a remainder layer (the remainder's key chain) and
  programmed PCM leaves run the same checks.

The keyed K8 at a shard's offsets (its plain version) equals the slice of
the whole grid's tile here too; ``tests/test_torch_keyed_draws.py`` holds
the kernel's draw chain at an offset to ``jax.random``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import aimc_device as JAD
from repro import engine as JE
from repro.configs import registry as JR
from repro.core import spikes as JSP
from repro.engine import IntegerBackend as JIntegerBackend
from repro.models import transformer as JT
from repro.models.moe import ParallelCtx
from repro_torch import convert
from repro_torch.configs import registry as R
from repro_torch.engine import XpikeformerEngine, get_backend
from repro_torch.kernels import ref as KREF
from repro_torch.models import transformer as T

ARCH = "xpikeformer-gpt-4-256"
# layernorm + the unembed matmul, and the loss's logsumexp: XLA and PyTorch
# round in other orders
ATOL = 1e-4

# name -> (config changes, batch, sequence length)
CASES = {
    "base": ({}, 2, 12),
    "s37": ({}, 3, 37),
    "gqa": ({"num_kv_heads": 2}, 2, 12),
    "lif": ({"attention_kind": "lif"}, 2, 37),
    "remainder": ({"block_pattern": ("attn", "local"), "num_layers": 3}, 2,
                  12),
}


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _eq(got, want, what=""):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got, want.astype(got.dtype)), (
        f"{what}: {np.sum(got != want)} of {got.size} elements differ")


def _cfgs(case):
    change = CASES[case][0]
    return (dataclasses.replace(JR.reduced_config(ARCH), **change),
            dataclasses.replace(R.reduced_config(ARCH), **change))


def _tokens(case, extra=0):
    _, b, s = CASES[case]
    rng = np.random.default_rng(len(case) + 10 * s)
    return rng.integers(0, 257, (b, s + extra)).astype(np.int32)


def _jax_blocks(cfg):
    """JAX's rate-encoded input, each block's key and output (the
    reference's key chain, ``_apply_block_spiking`` on its integer
    backend) and the forward's logits, in one compile."""
    backend = JIntegerBackend()

    @jax.jit
    def run(params, tokens, rng):
        x = JT._embed_inputs(params, {"tokens": tokens}, cfg)
        k_enc, k_blocks = jax.random.split(rng)
        s = JSP.rate_encode(k_enc, jax.nn.sigmoid(x), cfg.spike_T)
        n_blocks = cfg.num_periods + (1 if cfg.remainder_layers else 0)
        keys = jax.random.split(k_blocks, max(n_blocks, 1))
        todo = []
        for p in range(cfg.num_periods):
            kk = jax.random.split(keys[p], cfg.period)
            pp = jax.tree.map(lambda a: a[p], params["periods"])
            todo += [(pp[f"blk{i}"], m, kk[i])
                     for i, m in enumerate(cfg.block_pattern)]
        if cfg.remainder_layers:
            kk = jax.random.split(keys[-1], cfg.remainder_layers)
            todo += [(params["remainder"][f"blk{i}"], cfg.block_pattern[i],
                      kk[i]) for i in range(cfg.remainder_layers)]
        ins, outs, bkeys = [], [], []
        cur = s
        for bp, mixer, key in todo:
            ins.append(cur)
            cur, _ = JT._apply_block_spiking(bp, cur, cfg, ParallelCtx(),
                                             mixer, key, backend)
            outs.append(cur)
            bkeys.append(key)
        logits, _ = JT.forward(params, {"tokens": tokens}, cfg, rng=rng,
                               backend=backend, remat="none")
        return ins, outs, bkeys, k_blocks, logits

    return run


@functools.lru_cache(maxsize=None)
def _case(name):
    """JAX's side of one case: its config, weights, tokens, key, the
    blocks' inputs, outputs and keys, and the logits."""
    jcfg, tcfg = _cfgs(name)
    jparams = JT.init_params(jax.random.PRNGKey(1), jcfg)
    tokens = _tokens(name)
    jrng = jax.random.PRNGKey(17)
    ins, outs, bkeys, k_blocks, logits = _jax_blocks(jcfg)(
        jparams, jnp.asarray(tokens), jrng)
    long_tokens = _tokens(name, extra=1)
    mask = (np.arange(long_tokens.shape[1] - 1) % 3 != 0).astype(np.float32)
    mask = np.broadcast_to(mask, (long_tokens.shape[0], mask.size)).copy()
    loss = jax.jit(lambda p, b, r: JT.loss_fn(
        p, b, jcfg, rng=r, backend=JIntegerBackend(), remat="none"))
    losses = []
    for m in (None, mask):
        batch = {"tokens": jnp.asarray(long_tokens)}
        if m is not None:
            batch["mask"] = jnp.asarray(m)
        jloss, jaux = loss(jparams, batch, jrng)
        losses.append((m, float(jloss), float(jaux["xent"]),
                       float(jaux["moe_aux"])))
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                long_tokens=long_tokens, losses=losses,
                tparams=convert.params_from_numpy(
                    jax.tree.map(np.asarray, jparams), device="cpu"),
                tokens=tokens, jrng=jrng,
                trng=_t(np.asarray(jrng).astype(np.int64)), ins=ins,
                outs=outs, bkeys=bkeys, k_blocks=k_blocks,
                logits=np.asarray(logits))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return _case(request.param)


def _layer_params(tparams, cfg, layer):
    """Layer ``layer``'s block (programmed state indexed too)."""
    n = cfg.num_periods * cfg.period
    if layer < n:
        p, i = divmod(layer, cfg.period)
        return T._take(tparams["periods"], p)[f"blk{i}"]
    return tparams["remainder"][f"blk{layer - n}"]


@pytest.mark.parametrize("backend", ["integer", "cuda"])
def test_block_spikes_equal_jax(case, backend):
    """Each block's spike trains, given JAX's input to it, equal JAX's
    integer backend's bit for bit; the port's key chain gives every block
    JAX's key."""
    tcfg, be = case["tcfg"], get_backend(backend)
    keys = T._block_keys(_t(np.asarray(case["k_blocks"]).astype(np.int64)),
                         tcfg)
    _eq(keys, np.stack([np.asarray(k) for k in case["bkeys"]]), "block keys")
    pattern = [tcfg.block_pattern[i % tcfg.period]
               for i in range(tcfg.num_layers)]
    for layer, (s_in, want) in enumerate(zip(case["ins"], case["outs"])):
        got = T._apply_block_spiking(
            _layer_params(case["tparams"], tcfg, layer), _t(s_in), tcfg,
            pattern[layer], keys[layer], be)
        assert got.dtype == torch.float32
        _eq(got, want, f"block {layer}")
        assert 0 < float(got.sum()) < got.numel() * tcfg.num_layers + 1


@pytest.mark.parametrize("backend", ["integer", "cuda"])
def test_forward_and_loss_equal_jax(case, backend):
    """``forward``'s logits, ``prefill``'s and ``engine.forward``'s within
    ``ATOL`` of JAX's; ``loss_fn`` against JAX's ``loss_fn``."""
    tcfg, tparams, trng = case["tcfg"], case["tparams"], case["trng"]
    tokens = _t(case["tokens"]).long()
    logits, aux = T.forward(tparams, {"tokens": tokens}, tcfg, rng=trng,
                            backend=backend)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), case["logits"], rtol=0,
                               atol=ATOL)
    pre, _ = T.prefill(tparams, {"tokens": tokens}, tcfg, rng=trng,
                       backend=backend)
    assert torch.equal(pre, logits)
    eng = XpikeformerEngine.from_config(tcfg, backend=backend, device="cpu")
    assert eng.task == "lm"
    assert torch.equal(eng.forward(tokens, trng, tparams), logits)

    for m, jloss, jxent, jmoe in case["losses"]:
        tbatch = {"tokens": _t(case["long_tokens"]).long()}
        if m is not None:
            tbatch["mask"] = _t(m)
        loss, aux = T.loss_fn(tparams, tbatch, tcfg, rng=trng,
                              backend=backend)
        assert abs(float(loss) - jloss) < ATOL
        assert abs(float(aux["xent"]) - jxent) < ATOL
        assert float(aux["moe_aux"]) == jmoe == 0.0


def test_reference_prefill_needs_an_rng():
    """The reference's ``prefill`` passes no rng to ``forward``, so its
    spiking forward's assertion fails: the port's ``prefill`` takes one,
    and the test above holds it to JAX's ``forward``."""
    case = _case("base")
    with pytest.raises(AssertionError, match="rng"):
        JT.prefill(case["jparams"], {"tokens": jnp.asarray(case["tokens"])},
                   case["jcfg"])
    with pytest.raises(ValueError, match="rng"):
        T.prefill(case["tparams"], {"tokens": _t(case["tokens"]).long()},
                  case["tcfg"], backend="integer")


def _jax_metered_blocks(case):
    """JAX's ``MeteringBackend`` report of the forward's blocks, each run
    eagerly on its JAX input: the reference's ``engine.forward(task="lm",
    metering=True)`` cannot run, since it counts on the host inside the
    ``lax.scan`` over periods (checked here too)."""
    jcfg, jparams = case["jcfg"], case["jparams"]
    jeng = JE.XpikeformerEngine.from_config(jcfg, backend="integer")
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jeng.forward(jnp.asarray(case["tokens"]), case["jrng"], jparams,
                     metering=True)
    meter = JE.MeteringBackend(JIntegerBackend())
    for layer, (s_in, key) in enumerate(zip(case["ins"], case["bkeys"])):
        p, i = divmod(layer, jcfg.period)
        bp = jax.tree.map(lambda a: a[p], jparams["periods"])[f"blk{i}"]
        JT._apply_block_spiking(bp, s_in, jcfg, ParallelCtx(),
                                jcfg.block_pattern[i], key, meter)
    return meter.report


@pytest.mark.parametrize("name", ["base", "gqa"])
def test_metered_forward_equals_jax(name):
    """``engine.forward(tokens, key, metering=True)``: the logits of the
    unmetered forward, and JAX's ``MeteringBackend`` report of the same
    blocks (spike counts and calls exactly, picojoules within float
    rounding)."""
    case = _case(name)
    jrep = _jax_metered_blocks(case)
    eng = XpikeformerEngine.from_config(case["tcfg"], backend="cuda",
                                        device="cpu")
    tokens = _t(case["tokens"]).long()
    logits, rep = eng.forward(tokens, case["trng"], case["tparams"],
                              metering=True)
    assert torch.equal(logits, eng.forward(tokens, case["trng"],
                                           case["tparams"]))
    want, got = jrep.as_dict(), rep.as_dict()
    assert got.keys() == want.keys()
    for k in ("spikes_in", "spikes_out", "calls"):
        assert got[k] == want[k], k
    for k in ("aimc_pj", "ssa_pj", "lif_pj", "total_pj", "total_j"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    assert got["calls"] == 7 * case["tcfg"].num_layers


def test_programmed_forward_equals_jax():
    """Programmed PCM leaves (JAX's ``program_lm_tree`` drifted a day,
    carried over through numpy) pass through ``_lin_operand``: the blocks'
    spike trains equal JAX's, the logits within ``ATOL``."""
    jcfg, tcfg = _cfgs("base")
    jparams = JT.init_params(jax.random.PRNGKey(1), jcfg)
    acfg = JAD.AIMCConfig()
    jhw = JAD.drift_tree(JAD.program_lm_tree(jax.random.PRNGKey(3), jparams,
                                             acfg), 86400.0, acfg)
    tokens = _tokens("base")
    jrng = jax.random.PRNGKey(5)
    ins, outs, _, k_blocks, jlogits = _jax_blocks(jcfg)(
        jhw, jnp.asarray(tokens), jrng)
    thw = convert.params_from_numpy(jax.tree.map(np.asarray, jhw),
                                    device="cpu")
    keys = T._block_keys(_t(np.asarray(k_blocks).astype(np.int64)), tcfg)
    for layer, (s_in, want) in enumerate(zip(ins, outs)):
        got = T._apply_block_spiking(_layer_params(thw, tcfg, layer),
                                     _t(s_in), tcfg, "attn", keys[layer],
                                     get_backend("cuda"))
        _eq(got, want, f"programmed block {layer}")
    logits, _ = T.forward(thw, {"tokens": _t(tokens).long()}, tcfg,
                          rng=_t(np.asarray(jrng).astype(np.int64)),
                          backend="integer")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("b0,h0,b,h", [(0, 0, 4, 4), (2, 1, 2, 2),
                                       (3, 3, 1, 1), (0, 2, 4, 2)])
def test_keyed_tile_at_an_offset_is_the_whole_tiles_slice(b0, h0, b, h):
    """The keyed K8's plain version on a block of a ``[T, 4, 4]`` tile grid
    (its batch rows from ``b0``, heads from ``h0``) equals that block of
    the whole grid's output; a block past the grid is refused."""
    rng = np.random.default_rng(b0 + 4 * h0)
    shape = (2, 4, 4, 21, 16)
    q, k, v = (_t((rng.random(shape) < p).astype(np.uint8))
               for p in (0.5, 0.6, 0.4))
    key = torch.tensor([123, 456], dtype=torch.int64)
    whole = KREF.ssa_attention_keyed_ref(q, k, v, key, causal=True)
    sl = (slice(None), slice(b0, b0 + b), slice(h0, h0 + h))
    got = get_backend("cuda").ssa_attention(
        key, q[sl], k[sl], v[sl], causal=True, b0=b0, h0=h0, batch=4,
        heads=4)
    _eq(got, whole[sl])
    with pytest.raises(ValueError, match="outside"):
        KREF.ssa_attention_keyed_ref(q[sl], k[sl], v[sl], key, b0=b0 + 1,
                                     h0=h0, batch=b0 + b, heads=4)


def test_spiking_stack_with_an_ssd_mixer():
    """A spiking SSA stack whose second layer is SSD, run on the rate
    interface (the rate decoded, the float mixer, its sigmoid coded
    again): the forward's logits and twelve decode steps' against JAX's on
    its ``IntegerBackend`` within ``ATOL`` (the rate coding's sigmoid is
    the float boundary; no spike flips at these seeds)."""
    change = {"block_pattern": ("attn", "ssd"), "ssm_state_dim": 16}
    jcfg = dataclasses.replace(JR.reduced_config(ARCH), **change)
    tcfg = dataclasses.replace(R.reduced_config(ARCH), **change)
    tparams = T.init_params(tcfg, 0, "cpu")
    jparams = jax.tree.map(jnp.asarray, convert.params_to_numpy(tparams))
    tokens = np.random.default_rng(5).integers(0, 257, (2, 12)).astype(
        np.int32)
    want = jax.jit(lambda p, x, k: JT.forward(
        p, {"tokens": x}, jcfg, rng=k, backend=JIntegerBackend())[0])(
            jparams, tokens, jax.random.PRNGKey(3))
    with torch.no_grad():
        got, _ = T.forward(tparams, {"tokens": _t(tokens).long()}, tcfg,
                           rng=_t(np.asarray(jax.random.PRNGKey(3)).astype(
                               np.int64)), backend="integer")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    seeds = np.arange(2, dtype=np.uint32)
    step = jax.jit(lambda p, c, t: JT.decode_step(
        p, c, t, jcfg, backend=JIntegerBackend(), seeds=seeds))
    jcache = JT.init_cache(jcfg, 2, 12)
    tcache = T.init_cache(tcfg, 2, 12, "cpu")
    for i in range(12):
        want, jcache = step(jparams, jcache, tokens[:, i:i + 1])
        got, tcache = T.decode_step(
            tparams, tcache, _t(tokens[:, i:i + 1]).long(), tcfg,
            backend=get_backend("integer"), seeds=_t(seeds.astype(np.int64)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL, err_msg=f"step {i}")


def test_unported_stacks_raise():
    """MoE builds and decodes on one device (``tests/test_torch_moe.py``
    holds it to JAX) and builds on a mesh (``tests/test_torch_mesh.py``
    serves and trains it there); a training mesh places a MoE config and
    a model axis (the training cut); the front door, trace sink and
    profiler take ``--mesh`` (``tests/test_torch_caps.py``, A9(b)).  The
    float stack, a
    spiking stack with an SSD mixer (on the rate interface), the decode of
    a LIF-attention stack (the reference's float path) and a spiking MoE
    run: a decode step gives finite logits."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.distributed import Executor
    from repro_torch.launch.mesh import ServingMesh
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import loop as TL

    _, tcfg = _cfgs("base")
    moe = dataclasses.replace(tcfg, num_experts=4, moe_top_k=2)
    mesh = ServingMesh((1, 2), 0, torch.device("cpu"))
    for cfg in (moe, dataclasses.replace(moe, spiking=False)):
        ex = Executor(T.init_params(cfg, 0, "cpu"), cfg, "integer", mesh)
        assert ex.pctx.tp == 2
    assert callable(TL.make_train_step(
        moe, ParallelConfig(),
        mesh=ServingMesh((2, 1), 0, torch.device("cpu"))))
    cut = SH.placement_specs(SH.param_placement(tcfg, (1, 2), device="cpu"))
    assert cut["['periods']['blk0']['mixer']['wq']"] == \
        "(None, None, 'model')"
    tokens = torch.tensor([[3], [5]])
    for change in ({"spiking": False}, {"block_pattern": ("attn", "ssd"),
                                        "ssm_state_dim": 16},
                   {"attention_kind": "lif"},
                   {"num_experts": 4, "moe_top_k": 2},
                   {"num_experts": 4, "moe_top_k": 2, "spiking": False}):
        cfg = dataclasses.replace(tcfg, **change)
        params = T.init_params(cfg, 0, "cpu")
        cache = T.init_cache(cfg, 2, 8, "cpu")
        logits, _ = T.decode_step(params, cache, tokens, cfg,
                                  backend=get_backend("integer"))
        assert logits.shape == (2, 1, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
