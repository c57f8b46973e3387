"""The port's serving slice against the JAX package, end to end on the CPU.

On the reduced ``xpikeformer-gpt-4-256`` (2 layers, ``d=64``, 4 heads of
width 16), with the reference's weights carried over by
:mod:`repro_torch.convert`:

* each decoder layer's spike trains and new K/V trains equal the
  reference's exactly, given the reference's rate-encoded input, on the
  unfused and the fused paths;
* the port's fused and unfused decode steps are identical;
* the logits of a few decode steps agree within ``LOGITS_ATOL`` (the float
  tail: layernorm and the unembed matmul round differently in XLA and
  PyTorch), and the caches exactly;
* the dense ``BatchScheduler``'s token streams equal JAX's
  ``BatchScheduler(..., IntegerBackend(), slots=4, cache_len=32)`` under
  mid-flight admission and eviction.

Also: the port and ``chip_smoke.py`` import neither JAX nor ``repro``, and
the entry points refuse to run without CUDA unless given ``device="cpu"``.
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.engine import IntegerBackend as JIntegerBackend
from repro.kernels.plan import build_decode_plan as j_build_decode_plan
from repro.models import transformer as JT
from repro.models.moe import ParallelCtx
from repro.serving import BatchScheduler as JBatchScheduler
from repro_torch import convert
from repro_torch.configs import registry as R
from repro_torch.engine import XpikeformerEngine, get_backend
from repro_torch.kernels.plan import build_decode_plan
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.serving import BatchScheduler

ARCH = "xpikeformer-gpt-4-256"
ROOT = pathlib.Path(__file__).resolve().parents[1]
# layernorm + a 64-wide float32 unembed: XLA and PyTorch sum in other orders
LOGITS_ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg = JR.reduced_config(ARCH)
    jparams = JT.init_params(jax.random.PRNGKey(0), cfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return cfg, R.reduced_config(ARCH), jparams, tparams


def _keys(seeds):
    return jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))


def _tkeys(jkeys):
    return torch.from_numpy(np.asarray(jkeys).astype(np.int64))


def _eq(got, want):
    got = got.cpu().numpy()
    want = np.asarray(want).astype(got.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want), f"{np.sum(got != want)} elements differ"


@pytest.mark.parametrize("name", sorted(R.ARCHS))
def test_configs_match_reference(name):
    for port, ref in ((R.get_config(name), JR.get_config(name)),
                      (R.reduced_config(name), JR.reduced_config(name))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.resolved_head_dim == ref.resolved_head_dim
        assert port.num_periods == ref.num_periods


def test_convert_keeps_the_stacked_layout(setup):
    cfg, tcfg, jparams, tparams = setup
    assert tparams["periods"]["blk0"]["mixer"]["wq"].shape == (2, 64, 4, 16)
    lp = convert.layer_params(tparams, tcfg, 1)
    _eq(lp["mlp"]["wi"], jparams["periods"]["blk0"]["mlp"]["wi"][1])


def _random_cache(rng, cfg, b, l, pos):
    """One layer's cache holding spikes below each slot's ``pos``."""
    shape = (b, cfg.spike_T, l, cfg.num_kv_heads, cfg.resolved_head_dim)
    sk = (rng.random(shape) < 0.4).astype(np.uint8)
    sv = (rng.random(shape) < 0.4).astype(np.uint8)
    for i, p in enumerate(pos):
        sk[i, :, p:] = 0
        sv[i, :, p:] = 0
    return {"sk": sk, "sv": sv, "pos": np.asarray(pos, np.int32)}


@pytest.mark.parametrize("kernel", ["unfused", "fused"])
@pytest.mark.parametrize("layer", [0, 1])
def test_layer_spikes_and_kv_exact(setup, layer, kernel):
    """Given the reference's rate-encoded input, one layer's output spike
    stream and its cache (new K/V scattered at ``pos``) are bit-equal."""
    cfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(layer)
    b, l = 3, 24
    pos = [0, 7, 23]
    cache = _random_cache(rng, cfg, b, l, pos)
    jkeys = _keys([5, 6, 7])
    x = jax.random.normal(jax.random.PRNGKey(layer), (b, 1, cfg.d_model)) * 3
    s = JT._slot_rate_encode(jkeys, x, cfg.spike_T)  # the reference's spikes
    jblk = jax.tree.map(lambda a: a[layer], jparams["periods"]["blk0"])
    jplan = j_build_decode_plan(cfg, JIntegerBackend(), kernel=kernel)
    js, jc = JT._apply_block_spiking_decode(
        jblk, s, {k: jnp.asarray(v) for k, v in cache.items()}, cfg,
        ParallelCtx(), "attn", jkeys, layer, JIntegerBackend(), jplan)
    for backend in ("integer", "cuda"):
        be = get_backend(backend)
        tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
        ts = T._apply_block_spiking_decode(
            convert.layer_params(tparams, tcfg, layer),
            torch.from_numpy(np.array(s)), tc, tcfg, _tkeys(jkeys), layer,
            be, build_decode_plan(tcfg, be, kernel=kernel))
        _eq(ts, js)
        for k in ("sk", "sv", "pos"):
            _eq(tc[k], jc[k])


def _port_decode(tparams, tcfg, cache, tokens, seeds, kernel):
    be = get_backend("cuda")
    logits, cache, act = T.decode_step(
        tparams, cache, tokens, tcfg, backend=be, seeds=seeds,
        with_activity=True, plan=build_decode_plan(tcfg, be, kernel=kernel))
    return logits, act


def test_decode_steps_match_reference(setup):
    """Three batched decode steps from a common cache: caches and
    activity exact, logits within ``LOGITS_ATOL``, greedy tokens equal;
    fused and unfused port steps identical."""
    cfg, tcfg, jparams, tparams = setup
    b, l = 3, 16
    jcache = JT.init_cache(cfg, b, l)
    tcache = T.init_cache(tcfg, b, l, "cpu")
    ucache = T.init_cache(tcfg, b, l, "cpu")
    seeds = np.array([11, 12, 13], np.uint32)
    tok = np.array([[3], [100], [256]], np.int32)
    be = JIntegerBackend()
    jplan = j_build_decode_plan(cfg, be)
    jstep = jax.jit(lambda p, c, t, sd: JT.decode_step(
        p, c, t, cfg, backend=be, seeds=sd, with_activity=True, plan=jplan))
    for _ in range(3):
        jl, jcache, jact = jstep(jparams, jcache, jnp.asarray(tok),
                                 jnp.asarray(seeds))
        ttok = torch.from_numpy(tok.astype(np.int64))
        tseeds = torch.from_numpy(seeds.astype(np.int64))
        tl, tact = _port_decode(tparams, tcfg, tcache, ttok, tseeds, "fused")
        ul, uact = _port_decode(tparams, tcfg, ucache, ttok, tseeds, "unfused")
        assert torch.equal(tl, ul) and torch.equal(tact, uact)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGITS_ATOL)
        _eq(tact, jact)
        for k in ("sk", "sv", "pos"):
            _eq(tcache["periods"]["blk0"][k], jcache["periods"]["blk0"][k])
            assert torch.equal(tcache["periods"]["blk0"][k],
                               ucache["periods"]["blk0"][k])
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1))
        assert np.array_equal(tl[:, 0].argmax(-1).numpy(), nxt)
        tok = nxt[:, None].astype(np.int32)


def _prompt(i, length, vocab):
    return [(7 * i + 3 * j + 1) % vocab for j in range(length)]


def _drive(sch, vocab):
    """Mid-flight admission and eviction: 6 requests over 4 slots, a
    requeue eviction in flight, and a late submission."""
    rids = [sch.submit(_prompt(i, 2 + 3 * i % 7, vocab), 4 + i % 3, seed=50 + i)
            for i in range(6)]
    for _ in range(2):
        sch.step()
    sch.evict(1, requeue=True)
    rids.append(sch.submit(_prompt(9, 5, vocab), 5, seed=77))
    sch.step()
    sch.evict(2)
    out = sch.run()
    return {r: list(out[r]) for r in rids if r in out}, sch.stats


@pytest.fixture(scope="module")
def reference_serving(setup):
    cfg, tcfg, jparams, tparams = setup
    return _drive(JBatchScheduler(jparams, cfg, JIntegerBackend(), slots=4,
                                  cache_len=32), cfg.vocab_size)


@pytest.mark.parametrize("backend,kernel", [("cuda", "auto"),
                                            ("cuda", "unfused")])
def test_scheduler_tokens_match_reference(setup, reference_serving, backend,
                                          kernel):
    cfg, tcfg, jparams, tparams = setup
    want, jst = reference_serving
    sch = BatchScheduler(tparams, tcfg, backend, slots=4, cache_len=32,
                         decode_kernel=kernel, device="cpu")
    assert sch.plan.fused == (kernel == "auto")
    got, st = _drive(sch, tcfg.vocab_size)
    assert got == want
    assert (st.decode_steps, st.decoded_tokens, st.admissions, st.evictions,
            st.prefill_tokens) == (jst.decode_steps, jst.decoded_tokens,
                                   jst.admissions, jst.evictions,
                                   jst.prefill_tokens)
    assert st.spike_events == jst.spike_events


def test_engine_generate_on_cpu(setup):
    """The engine facade serves request ``i`` on stream ``seed + i``
    through the (JAX-checked) scheduler, and reuses its scheduler."""
    cfg, tcfg, jparams, tparams = setup
    prompts = [_prompt(0, 3, 257), _prompt(1, 6, 257)]
    eng = XpikeformerEngine.from_config(ARCH, reduced=True, device="cpu")
    eng.params = tparams
    outs = eng.generate(prompts, max_new=3, slots=2, cache_len=16, seed=5)
    sch = BatchScheduler(tparams, tcfg, slots=2, cache_len=16, device="cpu")
    rids = [sch.submit(p, 3, seed=5 + i) for i, p in enumerate(prompts)]
    want = sch.run()
    assert outs == [want[r] for r in rids]
    assert eng.generate(prompts, max_new=3, slots=2, cache_len=16,
                        seed=5) == outs
    assert len(eng._schedulers) == 1


def test_serve_cli_on_cpu(capsys):
    outs = serve_cli.serve(ARCH, smoke=True, n_requests=3, slots=2,
                           max_new=2, cache_len=32, device="cpu")
    assert [len(o) for o in outs] == [2, 2, 2]
    assert "served 3 requests, 6 tokens" in capsys.readouterr().out


def test_entry_points_refuse_to_run_without_cuda(setup, monkeypatch):
    """CUDA is the default device: without one, each entry point raises
    unless the caller asks for the CPU."""
    cfg, tcfg, jparams, tparams = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchScheduler(tparams, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        XpikeformerEngine.from_config(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--arch", ARCH, "--smoke", "--requests", "1"])
    assert BatchScheduler(tparams, tcfg, device="cpu").device.type == "cpu"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20 and files[-1].exists()
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (
                f"{f.relative_to(ROOT)} imports {mod}")


def test_kernel_operands_on_the_serving_path(setup, monkeypatch):
    """Every tensor the serving path hands a kernel wrapper is contiguous
    and of the kernel's dtype -- what the CUDA branch checks and raises on,
    rehearsed here through the plain versions."""
    from repro_torch.kernels import aimc_matmul as KA
    from repro_torch.kernels import decode_fused as KFD
    from repro_torch.kernels import ssa_attention as KS

    seen = []

    def checked(fn, dtypes):
        def run(*args, **kw):
            for a, dt in zip(args, dtypes):
                for x in (a if isinstance(a, tuple) else (a,)):
                    if isinstance(x, torch.Tensor):
                        assert x.is_contiguous(), fn.__name__
                        assert dt is None or x.dtype == dt, (fn.__name__, x.dtype)
            seen.append(fn.__name__)
            return fn(*args, **kw)
        return run

    f32, u8, i32, i8 = torch.float32, torch.uint8, torch.int32, torch.int8
    monkeypatch.setattr(KA, "aimc_spiking_linear_kernel", checked(
        KA.aimc_spiking_linear_kernel, (f32, i8, f32, f32)))
    monkeypatch.setattr(KS, "ssa_decode_kernel", checked(
        KS.ssa_decode_kernel, (u8, u8, u8, i32, i32)))
    monkeypatch.setattr(KFD, "fused_decode_layer_kernel", checked(
        KFD.fused_decode_layer_kernel,
        (f32, u8, u8, None, None, None, None, None, None, None, i32, i32)))
    cfg, tcfg, jparams, tparams = setup
    sch = BatchScheduler(tparams, tcfg, "cuda", slots=2, cache_len=16,
                         device="cpu")
    sch.submit([1, 2, 3], 2, seed=1)
    sch.run()
    assert {"aimc_spiking_linear_kernel", "ssa_decode_kernel",
            "fused_decode_layer_kernel"} <= set(seen)


def test_evict_zeroes_the_slot(setup):
    """Eviction releases the slot: its spike trains and position are zero
    (which also masks it out of the comparators), the others untouched."""
    cfg, tcfg, jparams, tparams = setup
    sch = BatchScheduler(tparams, tcfg, "cuda", slots=2, cache_len=16,
                         device="cpu")
    sch.submit([1, 2, 3, 4], 5, seed=1)
    sch.submit([5, 6], 5, seed=2)
    sch.step()
    sch.step()
    blk = sch.state.cache["periods"]["blk0"]
    kept = blk["sk"][:, 1].clone()
    assert int(blk["sk"][:, 0].sum()) > 0
    sch.evict(0)
    for leaf in ("sk", "sv", "pos"):
        assert int(blk[leaf][:, 0].abs().sum()) == 0
    assert torch.equal(blk["sk"][:, 1], kept)
    assert int(sch.state.seeds[0]) == 0 and int(sch.state.tokens[0]) == 0
    with pytest.raises(ValueError, match="unoccupied"):
        sch.evict(0)
    with pytest.raises(ValueError, match="prompt tokens"):
        sch.submit([1, tcfg.vocab_size], 2)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA device -> a non-zero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, cwd=tmp_path,
                         timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
