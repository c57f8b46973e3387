"""The float LM stack in the port against the JAX package, end to end.

On the reduced configs of the eight non-MoE registry architectures
(``d=64``, 4 heads of 16, vocab 257, float32; ``gemma3-27b`` cut to one
period plus one layer (7) and ``recurrentgemma-9b`` to 4, so that both
the stacked periods and the remainder run), with JAX's weights carried
over through numpy, on the CPU:

* ``init_params`` draws JAX's ``init_params(PRNGKey(seed))`` (through the
  threefry twin: equal up to ``erfinv``'s last bits, ``INIT_ATOL``), so
  the other cases carry the port's weights to JAX;
* the forward's logits for all eight (frontend archs over embeddings),
  the loss and every gradient leaf for ``yi-9b`` and
  ``recurrentgemma-9b``;
* teacher-forced decode logits against JAX's ``decode_step`` for
  ``yi-9b``, ``gemma3-27b`` (the window's ring buffer wraps),
  ``recurrentgemma-9b``, ``mamba2-780m`` and a LIF-attention spiking GPT
  (the reference decodes it on its float path);
* ``BatchScheduler``'s greedy streams for ``yi-9b`` and ``mamba2-780m``
  equal to JAX's ``BatchScheduler``, with JAX's joules (zero: the static
  per-token energy is a spiking SSA stack's only);
* the entry points: ``launch.train.run`` (its first loss JAX's on the
  same stream batch), the serve CLI (a MoE arch too), the engine.

Logits agree within ``ATOL``: ``exp``, ``sigmoid``, ``sin``/``cos`` and
``pow`` are float boundaries against XLA, and XLA's CPU fusions contract
``a * b + c``.
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
from repro.models import transformer as JT
from repro.serving import BatchScheduler as JBatchScheduler
from repro_torch import convert
from repro_torch.configs import registry as R
from repro_torch.data.pipeline import DataConfig
from repro_torch.engine import XpikeformerEngine
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as LT
from repro_torch.models import transformer as T
from repro_torch.serving import BatchScheduler
from repro_torch.train import loop as TL

# float32 logits of order one (measured: at most 3.2e-6)
ATOL = 1e-5
# erfinv: torch's and XLA's differ in the last bits of a normal draw
INIT_ATOL = 2e-5
# a gradient leaf, against its largest value: sums of the backward in
# other orders
GRAD_RTOL = 1e-4

FLOAT_ARCHS = sorted(n for n, c in JR.ARCHS.items()
                     if not c.spiking and not c.is_moe)
# one period plus one layer: stacked periods and the remainder both run
CUT = {"gemma3-27b": 7, "recurrentgemma-9b": 4}
LIF_GPT = "xpikeformer-gpt-4-256-lif"


def _cfgs(arch):
    if arch == LIF_GPT:
        return tuple(dataclasses.replace(
            reg.reduced_config("xpikeformer-gpt-4-256"), attention_kind="lif")
            for reg in (JR, R))
    j, t = JR.reduced_config(arch), R.reduced_config(arch)
    if arch in CUT:
        j = dataclasses.replace(j, num_layers=CUT[arch])
        t = dataclasses.replace(t, num_layers=CUT[arch])
    return j, t


_SETUP = {}


def _setup(arch):
    """``(jcfg, tcfg, JAX params, the port's)``, once per arch: the port's
    ``init_params(seed 0)``, carried to JAX through numpy (jitting JAX's
    own init takes seconds an arch; ``test_init_params_draw_the_
    references`` holds the two draws equal)."""
    if arch not in _SETUP:
        jcfg, tcfg = _cfgs(arch)
        tp = T.init_params(tcfg, 0, "cpu")
        jp = jax.tree.map(jnp.asarray, convert.params_to_numpy(tp))
        _SETUP[arch] = (jcfg, tcfg, jp, tp)
    return _SETUP[arch]


def _inputs(cfg, b, s, seed):
    """numpy inputs of a forward: tokens, or a frontend's embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.frontend != "none":
        emb = rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32)
        return {"embeddings": emb}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _leaves(tree):
    """A tree's leaves in ``jax.tree``'s order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol, err_msg=what)


@pytest.fixture(autouse=True)
def one_thread():
    """Torch's CPU ops on one thread: the decode and serving cases run
    many small ops, whose thread teams would wait on threads the other
    test workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRAD_ARCHS = ("yi-9b", "recurrentgemma-9b")
DECODE_ARCHS = ("yi-9b", "gemma3-27b", "recurrentgemma-9b", "mamba2-780m",
                LIF_GPT)
FWD_SHAPE, GRAD_SHAPE, DECODE_SHAPE = (2, 16), (2, 13), (3, 12)
# one period of every mixer, a frontend, QKV biases, an unembedding
INIT_CFG = dict(block_pattern=("rglru", "ssd", "local", "attn"),
                num_layers=4, ssm_state_dim=16, qkv_bias=True,
                tie_embeddings=False, frontend="audio_frames",
                frontend_dim=24)


def _decode_tokens(cfg):
    return _inputs(dataclasses.replace(cfg, frontend="none"),
                   *DECODE_SHAPE, 3)["tokens"]


def _zero_cache(jcfg, b, s):
    """JAX's ``init_cache`` as numpy zeros (no eager JAX op a leaf)."""
    return jax.tree.map(lambda x: np.zeros(x.shape, x.dtype),
                        JT.cache_schema(jcfg, b, s))


SERVE_ARCHS = ("yi-9b", "mamba2-780m")
SERVE_PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9], [10, 11, 12, 13],
                 [5, 5, 5, 5, 5, 5, 5]]


def _jax_serve(arch):
    """JAX's ``BatchScheduler``: five requests through 3 slots, 5 new
    tokens each -> (streams, ``energy_j``, ``request_energy_j``, decoded
    tokens)."""
    jcfg, _, jp, _ = _setup(arch)
    sch = JBatchScheduler(jp, jcfg, slots=3, cache_len=24)
    rids = [sch.submit(p, 5, seed=i) for i, p in enumerate(SERVE_PROMPTS)]
    out = sch.run()
    return ([out[r] for r in rids], sch.stats.energy_j,
            dict(sch.request_energy_j), sch.stats.decoded_tokens)


def _reference_jobs():
    """``{name: (function, arguments)}``: every JAX computation the tests
    hold the port to."""
    jobs = {}
    for arch in FLOAT_ARCHS:
        jcfg, _, jp, _ = _setup(arch)
        jobs["forward", arch] = (
            lambda p, x, c=jcfg: JT.forward(p, x, c, remat="none")[0],
            (jp, _inputs(jcfg, *FWD_SHAPE, 1)))
    for arch in GRAD_ARCHS:
        jcfg, _, jp, _ = _setup(arch)
        jobs["grad", arch] = (jax.value_and_grad(
            lambda p, b, c=jcfg: JT.loss_fn(p, b, c, remat="none"),
            has_aux=True), (jp, _inputs(jcfg, *GRAD_SHAPE, 2)))
    for arch in DECODE_ARCHS:
        jcfg, _, jp, _ = _setup(arch)
        b, s = DECODE_SHAPE
        jobs["decode", arch] = (
            lambda p, cache, t, c=jcfg: JT.decode_step(p, cache, t, c),
            (jp, _zero_cache(jcfg, b, s), _decode_tokens(jcfg)[:, :1]))
    jcfg = dataclasses.replace(JR.reduced_config("recurrentgemma-9b"),
                               **INIT_CFG)
    jobs["init"] = (lambda k, c=jcfg: JT.init_params(k, c),
                    (jax.random.PRNGKey(0),))
    return jobs


def _compile(fn, args):
    return jax.jit(fn).lower(*args).compile()


@pytest.fixture(scope="module")
def refs():
    """The JAX computations, lowered and compiled in a pool of threads
    (XLA compiles in parallel): each test calls its compiled reference.  JAX's two serves run in the same pool (their steps
    compile as they go)."""
    jobs = _reference_jobs()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex:
        # the longest compiles first (the gradients, the init's draws),
        # then the serves, whose steps compile as they go
        futures = {k: ex.submit(_compile, *jobs.pop(k)) for k in
                   [("grad", a) for a in GRAD_ARCHS] + ["init"]}
        futures.update({("serve", a): ex.submit(_jax_serve, a)
                        for a in SERVE_ARCHS})
        futures.update({k: ex.submit(_compile, fn, args)
                        for k, (fn, args) in jobs.items()})
        return {k: f.result() for k, f in futures.items()}


def test_init_params_draw_the_references(refs):
    """Every leaf of a config with one period of every mixer (RG-LRU, SSD,
    local and global attention with QKV biases), an MLP, a frontend
    projection and an unembedding equals JAX's ``init_params
    (PRNGKey(0))``, in JAX's leaf order."""
    tcfg = dataclasses.replace(R.reduced_config("recurrentgemma-9b"),
                               **INIT_CFG)
    want = jax.tree.leaves(refs["init"](jax.random.PRNGKey(0)))
    got = _leaves(T.init_params(tcfg, 0, "cpu"))
    assert len(got) == len(want) > 40
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, INIT_ATOL)


@pytest.mark.parametrize("arch", FLOAT_ARCHS)
def test_forward_logits(refs, arch):
    jcfg, tcfg, jp, tp = _setup(arch)
    batch = _inputs(jcfg, *FWD_SHAPE, 1)
    with torch.no_grad():
        got, aux = T.forward(tp, _torch_batch(batch), tcfg)
    assert float(aux) == 0.0
    _close(got, refs["forward", arch](jp, batch))


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_gradients(refs, arch):
    """The next-token loss, its cross-entropy, the gradients' global norm
    and every gradient leaf against ``jax.value_and_grad`` (both without
    remat: ``remat="block"`` wraps each layer in the non-reentrant
    ``torch.utils.checkpoint``, which recomputes the same ops, and whose
    first call imports ``torch._dynamo``, seconds of this file's
    budget)."""
    jcfg, tcfg, jp, tp = _setup(arch)
    batch = _inputs(jcfg, *GRAD_SHAPE, 2)
    (jl, jaux), jg = refs["grad", arch](jp, batch)
    (tl, taux), tg = TL.value_and_grad(
        lambda p, b: T.loss_fn(p, b, tcfg, remat="none"))(
            tp, _torch_batch(batch))
    _close(tl, jl)
    _close(taux["xent"], jaux["xent"])
    got, want = _leaves(tg), jax.tree.leaves(jg)
    norm = lambda gs: float(np.sqrt(sum(np.sum(np.square(np.asarray(g)))
                                        for g in gs)))
    np.testing.assert_allclose(norm([g.numpy() for g in got]), norm(want),
                               rtol=GRAD_RTOL)
    for g, w in zip(got, want):
        _close(g, w, GRAD_RTOL * max(float(np.max(np.abs(w))), 1e-6))


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_reference(refs, arch):
    """Twelve teacher-forced decode steps of 3 slots (gemma3's window of 8
    wraps its ring buffer) against JAX's ``decode_step``; the port's
    decode also matches its own forward within the reference's 5e-3."""
    jcfg, tcfg, jp, tp = _setup(arch)
    b, s = DECODE_SHAPE
    tokens = _decode_tokens(jcfg)
    jcache = _zero_cache(jcfg, b, s)
    tcache = T.init_cache(tcfg, b, s, "cpu")
    outs = []
    for i in range(s):
        want, jcache = refs["decode", arch](jp, jcache, tokens[:, i:i + 1])
        got, tcache = T.decode_step(tp, tcache, torch.from_numpy(
            tokens[:, i:i + 1]).long(), tcfg)
        _close(got, want, what=f"step {i}")
        outs.append(got)
    for g, w in zip(_leaves(tcache), jax.tree.leaves(jcache)):
        _close(g.float(), np.asarray(w, np.float32))
    if not tcfg.spiking and tcfg.frontend == "none":
        full, _ = T.forward(tp, {"tokens": torch.from_numpy(tokens).long()},
                            tcfg, remat="none")
        _close(torch.cat(outs, 1), full.detach().numpy(), 5e-3)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_batch_scheduler_matches_reference(refs, arch):
    """Five requests through 3 slots (mid-flight admission and eviction):
    the greedy streams equal JAX's ``BatchScheduler``'s, and so do the
    joules: zero, in total and per request."""
    _, tcfg, _, tp = _setup(arch)
    want, energy, request_energy, decoded = refs["serve", arch]
    sch = BatchScheduler(tp, tcfg, slots=3, cache_len=24, device="cpu")
    assert sch.plan is None
    rids = [sch.submit(p, 5, seed=i) for i, p in enumerate(SERVE_PROMPTS)]
    out = sch.run()
    assert [out[r] for r in rids] == want
    assert sch.stats.energy_j == energy == 0.0
    assert sch.request_energy_j == request_energy
    assert sch.stats.decoded_tokens == decoded


def test_float_scheduler_refuses_the_spiking_layouts():
    """``decode_kernel="fused"`` and ``paged=True`` need a spiking SSA
    stack, as in the reference."""
    _, tcfg, _, tp = _setup("yi-9b")
    with pytest.raises(ValueError, match="fused"):
        BatchScheduler(tp, tcfg, decode_kernel="fused", device="cpu")
    with pytest.raises(ValueError, match="paged"):
        BatchScheduler(tp, tcfg, paged=True, device="cpu")


class _Stream:
    """A stand-in for ``MarkovStream`` (whose ``257**3`` transition table
    takes seconds to draw on one thread; ``tests/test_torch_train_launch
    .py`` holds the stream itself): ``batch_at(step)``, uniform tokens
    from ``seed + step``."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg, self.device = cfg, device

    def batch_at(self, step: int):
        rng = np.random.default_rng(self.cfg.seed + step)
        c = self.cfg
        tok = rng.integers(0, c.vocab_size, (c.global_batch, c.seq_len + 1))
        return {"tokens": torch.from_numpy(tok).to(self.device)}


def _xent(logits, targets):
    """The mean next-token cross-entropy of JAX's logits, in float64."""
    lf = np.asarray(logits, np.float64)
    m = lf.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(lf - m).sum(-1, keepdims=True)))[..., 0]
    gold = np.take_along_axis(lf, targets[..., None], -1)[..., 0]
    return float(np.mean(lse - gold))


def test_train_launcher(refs, tmp_path, monkeypatch):
    """``launch.train.run("yi-9b")`` on the CPU: its first loss is the
    cross-entropy of JAX's logits of the same weights (``init_params``
    draws JAX's) on the same batch; three steps, and the probe batch's
    loss falls."""
    jcfg, tcfg, jp, _ = _setup("yi-9b")
    b, s = FWD_SHAPE
    monkeypatch.setattr(LT, "MarkovStream", _Stream)
    losses, before, after = LT.run("yi-9b", steps=3, batch=b, seq_len=s,
                                   ckpt_dir=str(tmp_path), log_every=0,
                                   device="cpu", probe=True)
    tokens = _Stream(DataConfig(tcfg.vocab_size, s, b, seed=0)).batch_at(
        0)["tokens"].numpy()
    logits = refs["forward", "yi-9b"](
        jp, {"tokens": tokens[:, :-1].astype(np.int32)})
    assert len(losses) == 3 and all(np.isfinite(losses))
    np.testing.assert_allclose(losses[0], _xent(logits, tokens[:, 1:]),
                               rtol=0, atol=ATOL)
    assert before == pytest.approx(losses[0], abs=1e-6)
    assert after < before


def test_serve_cli_and_engine(refs, capsys):
    """The serve CLI on ``--device cpu`` for a dense, a frontend and a MoE
    arch (the reduced arctic, whose experts ``tests/test_torch_moe.py``
    holds to JAX); the engine's ``forward`` and ``generate``;
    ``--program`` needs a spiking SSA arch."""
    serve_cli.main(["--arch", "yi-9b", "--requests", "3", "--max-new", "4",
                    "--device", "cpu"])
    serve_cli.main(["--arch", "musicgen-medium", "--requests", "2",
                    "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out
    assert "serving over stub embeddings" in out and "served 2 requests" in out
    outs = serve_cli.serve("arctic-480b", smoke=True, device="cpu",
                           n_requests=2, max_new=3)
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out
    assert [len(o) for o in outs] == [3, 3]
    with pytest.raises(SystemExit, match="spiking SSA"):
        serve_cli.serve("yi-9b", smoke=True, device="cpu", program=True)

    jcfg, tcfg, jp, tp = _setup("yi-9b")
    eng = XpikeformerEngine.from_config("yi-9b", task="lm", reduced=True,
                                        device="cpu")
    eng.params = tp
    x = _inputs(jcfg, *FWD_SHAPE, 4)["tokens"]
    with torch.no_grad():
        got = eng.forward(torch.from_numpy(x).long())
    _close(got,
           refs["forward", "yi-9b"](jp, {"tokens": x}))
    prompts = [[3, 1, 4], [1, 5]]
    sch = BatchScheduler(tp, tcfg, slots=2, cache_len=16, device="cpu")
    rids = [sch.submit(p, 4, seed=i) for i, p in enumerate(prompts)]
    outs = sch.run()
    assert eng.generate(prompts, 4, cache_len=16) == [outs[r] for r in rids]


def test_float_entry_points_need_a_card_unless_asked_for_the_cpu(
        monkeypatch):
    """CUDA is the default device: without one, each float entry point
    raises unless the caller asks for the CPU; none falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, _, tp = _setup("yi-9b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchScheduler(tp, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        XpikeformerEngine.from_config("yi-9b", task="lm", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LT.run("mamba2-780m", steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--arch", "mamba2-780m", "--requests", "1"])
