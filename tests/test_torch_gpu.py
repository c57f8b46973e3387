"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``gpu``) and skips without one.
The file imports neither JAX nor the reference package, so it runs on a
machine with PyTorch alone::

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` configures JAX.)  The plain
versions are held against the JAX reference on the CPU by
``tests/test_torch_kernels.py``; here each kernel must equal them exactly,
at the serving path's widths and at the padding and GQA edges.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.engine import XpikeformerEngine
from repro_torch.kernels import aimc_matmul as KA
from repro_torch.kernels import build as KB
from repro_torch.kernels import decode_fused as KFD
from repro_torch.kernels import ref as KREF
from repro_torch.kernels import ssa_attention as KS

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build with nvcc for sm_90a")
    return torch.device("cuda")


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _eq(got, want):
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want), f"{int((got != want).sum())} elements differ"


def _triple(rng, d_in, d_out, bias=True):
    """Dyadic scales and biases: many membranes land on the threshold."""
    lv = rng.integers(-15, 16, (d_in, d_out)).astype(np.int8)
    sc = (rng.integers(1, 4, d_out) / 8.0).astype(np.float32)
    bi = (rng.integers(-4, 9, d_out) / 8.0).astype(np.float32)
    return _t(lv), _t(sc), (_t(bi) if bias else None)


def _to(w, dev):
    return None if w is None else tuple(None if x is None else x.to(dev)
                                        for x in w)


@pytest.mark.parametrize("t,m,d_in,d_out", [(4, 1, 256, 256), (4, 1, 256, 1024),
                                            (4, 1, 1024, 256), (3, 5, 64, 48)])
def test_spiking_linear_kernel(cuda, t, m, d_in, d_out):
    rng = np.random.default_rng(d_in + d_out)
    x = _t(rng.integers(0, 4, (t, m, d_in)).astype(np.float32))
    w = _triple(rng, d_in, d_out, bias=d_out != 48)
    want = KREF.aimc_spiking_linear_ref(x, *w)
    n = KB.LAUNCHES["aimc_spiking_linear"]
    got = KA.aimc_spiking_linear_kernel(x.to(cuda), *_to(w, cuda))
    torch.cuda.synchronize()
    assert KB.LAUNCHES["aimc_spiking_linear"] == n + 1
    _eq(got, want)


def _decode_inputs(rng, g, l, d):
    q = rng.integers(0, 2, (g, 1, d)).astype(np.uint8)
    k = (rng.random((g, l, d)) < 0.6).astype(np.uint8)
    v = (rng.random((g, l, d)) < 0.6).astype(np.uint8)
    k[:, l // 2:] = 0
    v[:, l // 2:] = 0
    rs = rng.integers(0, d, (g, 1, l)).astype(np.int32)
    ra = rng.integers(0, l, (g, 1, d)).astype(np.int32)
    return [_t(a) for a in (q, k, v, rs, ra)]


@pytest.mark.parametrize("g,l,d", [(16, 256, 64), (48, 24, 16), (8, 33, 40)])
def test_ssa_decode_kernel(cuda, g, l, d):
    args = _decode_inputs(np.random.default_rng(g + l), g, l, d)
    want = KREF.ssa_decode_ref(*args)
    got = KS.ssa_decode_kernel(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    _eq(got, want)


LAYER_CASES = {
    # name: (t, b, d, h, kv, hd, l, dff, pos, with_tail, with_mlp)
    "main_path": (4, 8, 256, 4, 4, 64, 256, 1024,
                  [0, 1, 40, 100, 200, 254, 255, 17], True, True),
    "padding": (4, 3, 64, 4, 4, 16, 24, 128, [0, 9, 23], True, True),
    "gqa": (4, 2, 256, 4, 2, 64, 64, 512, [5, 63], True, True),
    "masked_write": (2, 3, 48, 2, 2, 16, 24, 64, [24, 3, 30], True, True),
    "no_mlp": (3, 2, 64, 2, 1, 32, 40, 64, [1, 39], True, False),
    "no_tail": (4, 2, 64, 4, 4, 16, 24, 128, [7, 0], False, True),
}


def layer_inputs(rng, t, b, d, h, kv, hd, l, dff, pos):
    """One layer step's inputs under the serving invariant (cache rows at
    and past each slot's ``pos`` are zero)."""
    s = rng.integers(0, 3, (t, b, d)).astype(np.float32)
    sk = (rng.random((b, t, l, kv, hd)) < 0.5).astype(np.uint8)
    sv = (rng.random((b, t, l, kv, hd)) < 0.5).astype(np.uint8)
    for i, p in enumerate(pos):
        sk[i, :, p:] = 0
        sv[i, :, p:] = 0
    ws = [_triple(rng, d, h * hd), _triple(rng, d, kv * hd, bias=False),
          _triple(rng, d, kv * hd), _triple(rng, h * hd, d),
          _triple(rng, d, dff), _triple(rng, dff, d, bias=False)]
    rs = rng.integers(0, hd, (b, t, h, l)).astype(np.int32)
    ra = rng.integers(0, l, (b, t, h, hd)).astype(np.int32)
    return ([_t(s), _t(sk), _t(sv), _t(np.asarray(pos, np.int32))], ws,
            [_t(rs), _t(ra)])


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_fused_layer_kernel(cuda, case):
    t, b, d, h, kv, hd, l, dff, pos, tail, mlp = LAYER_CASES[case]
    head, ws, draws = layer_inputs(np.random.default_rng(len(case)), t, b, d,
                                   h, kv, hd, l, dff, pos)
    kw = dict(hd=hd, with_tail=tail, with_mlp=mlp)
    want = KREF.decode_layer_ref(*head, *ws, *draws, **kw)
    got = KFD.fused_decode_layer_kernel(
        *(a.to(cuda) for a in head), *(_to(w, cuda) for w in ws),
        *(a.to(cuda) for a in draws), **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _eq(g, w)


def test_reduced_serving_on_card_matches_cpu(cuda):
    """The reduced spiking GPT served on the card through the kernels gives
    the tokens of the plain versions on the CPU, and runs K3 once per layer
    and decode step."""
    cfg = reduced_config("xpikeformer-gpt-4-256")
    prompts = [[1, 2, 3, 4], [9, 8, 7, 6, 5, 4, 3], [100, 200]]
    outs = {}
    for dev, backend in (("cpu", "integer"), ("cuda", "cuda")):
        eng = XpikeformerEngine.from_config(cfg, backend=backend, device=dev)
        eng.init(0)
        KB.reset_launches()
        outs[dev], stats = eng.serve(prompts, 6, slots=2, cache_len=32)
    assert outs["cuda"] == outs["cpu"]
    assert KB.LAUNCHES["fused_decode_layer"] == (cfg.num_layers
                                                 * stats.decode_steps)
    assert KB.LAUNCHES["ssa_decode"] == cfg.num_layers * stats.prefill_tokens
