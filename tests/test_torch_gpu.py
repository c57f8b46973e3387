"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``gpu``) and skips without one.
The file imports neither JAX nor the reference package, so it runs on a
machine with PyTorch alone::

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` configures JAX.)  The plain
versions are held against the JAX reference on the CPU by
``tests/test_torch_kernels.py``, ``tests/test_torch_paged.py``,
``tests/test_torch_paper.py`` and ``tests/test_torch_pcm.py``; here each
kernel must equal them exactly, at the serving path's and the paper
models' widths and at the padding, GQA, causal and row-count edges, and
the paper forwards through the kernels, programmed or not, must give the
plain versions' logits bit for bit; a two-rank mesh sharing the card must
serve one device's tokens through K5.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.configs import reduced_config
from repro_torch.configs.xpikeformer import SPIKING_ARCHS
from repro_torch.data import icl_mimo as MIMO
from repro_torch.data import synthetic_images as SI
from repro_torch.engine import CudaBackend, XpikeformerEngine
from repro_torch.kernels import aimc_matmul as KA
from repro_torch.kernels import build as KB
from repro_torch.kernels import decode_fused as KFD
from repro_torch.kernels import drift_requantize as KD
from repro_torch.kernels import lif as KL
from repro_torch.kernels import ref as KREF
from repro_torch.kernels import ssa_attention as KS
from repro_torch.serving import NULL_PAGE, RESERVED_PAGES, TRASH_PAGE

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


KEYED_CASES = {
    # name: (t, b, h, l, d, h0, i_max, pos or None): the dense prefill row
    # of xpikeformer-gpt-4-256, three slots of distinct live lengths, a
    # rank's head offset, no pos (every row read), ragged widths
    "prefill": (4, 1, 4, 256, 64, 0, 256, [20]),
    "b3": (4, 3, 4, 256, 64, 0, 256, [0, 131, 256]),
    "h0": (4, 3, 2, 256, 64, 2, 256, [7, 256, 64]),
    "no_pos": (4, 2, 4, 256, 64, 1, 256, None),
    "ragged": (3, 3, 3, 33, 40, 3, 20, [1, 33, 20]),
}


def keyed_inputs(rng, t, b, h, l, d, pos):
    """``q``, the cache as the serving path holds it (``[B,T,L,H,D]``,
    rows at and past each slot's ``pos`` zero) and distinct slot keys."""
    q = _t(rng.integers(0, 2, (t, b, h, 1, d)).astype(np.uint8))
    sk = (rng.random((b, t, l, h, d)) < 0.5).astype(np.uint8)
    sv = (rng.random((b, t, l, h, d)) < 0.5).astype(np.uint8)
    for i, p in enumerate(pos or []):
        sk[i, :, p:] = 0
        sv[i, :, p:] = 0
    keys = prng.key_from_seeds(_t(rng.integers(0, 2 ** 32, b, dtype=np.uint64)
                                  .astype(np.int64)))
    return q, _t(sk), _t(sv), keys


@pytest.mark.parametrize("case", sorted(KEYED_CASES))
def test_keyed_decode_row_kernel(cuda, case):
    """The K2 that draws its own comparators, over the permuted cache view
    (no copy) and each slot's ``pos``, equals its plain version (the
    threefry twin's draws, then ``ssa_decode_ref`` over every row); with
    garbage in the rows past ``pos`` it still does (it never reads
    them)."""
    t, b, h, l, d, h0, i_max, pos = KEYED_CASES[case]
    rng = np.random.default_rng(l + b + h0)
    q, sk, sv, keys = keyed_inputs(rng, t, b, h, l, d, pos)
    view = lambda x: x.permute(1, 0, 3, 2, 4)  # noqa: E731
    want = KREF.ssa_decode_keyed_ref(q, view(sk), view(sv), keys, h0,
                                     i_max=i_max)
    tpos = None if pos is None else _t(np.int32(pos)).to(cuda)
    n = KB.LAUNCHES["ssa_decode"]
    got = KS.ssa_decode_keyed_kernel(
        q.to(cuda), view(sk.to(cuda)), view(sv.to(cuda)), keys.to(cuda), tpos,
        h0=h0, i_max=i_max)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["ssa_decode"] == n + 1
    _eq(got, want)
    assert 0 < int(want.sum()) < want.numel()
    if pos is not None:
        gk, gv = sk.clone(), sv.clone()
        for i, p in enumerate(pos):
            gk[i, :, p:] = 1
            gv[i, :, p:] = 1
        _eq(KS.ssa_decode_keyed_kernel(
            q.to(cuda), view(gk.to(cuda)), view(gv.to(cuda)), keys.to(cuda),
            tpos, h0=h0, i_max=i_max), want)


def dispatched_ops(fn):
    """``fn()`` and the names of the PyTorch ops it dispatched (a ctypes
    launch dispatches none)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    with Ops() as ops:
        out = fn()
    torch.cuda.synchronize()
    return out, ops.seen


def test_keyed_decode_row_dispatches_no_torch_op(cuda):
    """On the card the serving path's decode row (``CudaBackend.
    decode_attention`` over the dense view) is the one K2 launch: no
    threefry-twin op, no copy of the cache, nothing but the output's
    allocation reaches PyTorch's dispatcher."""
    from repro_torch.kernels.plan import AttnSpec, KVView

    t, b, h, l, d, h0, i_max, pos = KEYED_CASES["b3"]
    q, sk, sv, keys = keyed_inputs(np.random.default_rng(3), t, b, h, l, d,
                                   pos)
    q, sk, sv, keys = (x.to(cuda) for x in (q, sk, sv, keys))
    view = KVView.dense(sk.permute(1, 0, 3, 2, 4), sv.permute(1, 0, 3, 2, 4),
                        _t(np.int32(pos)).to(cuda))
    got, seen = dispatched_ops(lambda: CudaBackend().decode_attention(
        view, q, AttnSpec(i_max, h0), slot_keys=keys))
    assert [f for f in seen if not f.startswith("aten.empty")] == []
    _eq(got, KREF.ssa_decode_keyed_ref(q, view.k, view.v, keys, h0,
                                       i_max=i_max))


@pytest.mark.parametrize("bias", [True, False])
def test_row_parallel_epilogue_is_one_launch(cuda, bias):
    """A row-parallel spiking linear on the card (a one-process stand-in
    for the model group, whose ``all_reduce`` of whole rows is the
    identity) is K5 then one K4 launch: beside those, only the outputs'
    allocations and views reach the dispatcher (no ``* scale``, no ``+
    b``); the spikes are the single-device linear's."""
    from types import SimpleNamespace

    from repro_torch.distributed.backend import ShardedBackend

    cfg = reduced_config("xpikeformer-gpt-4-256")
    mesh = SimpleNamespace(model=2, model_index=0,
                           all_reduce_model=lambda x: x)
    be = ShardedBackend(CudaBackend(), mesh, cfg)
    rng = np.random.default_rng(7 + bias)
    lv, sc, bi = _triple(rng, 64, 48, bias=bias)
    p = {"levels": lv.to(cuda), "scale": sc.to(cuda),
         "b": None if bi is None else bi.to(cuda)}
    x = _t(rng.integers(0, 2, (4, 3, 1, 64)).astype(np.float32))
    xc = x.to(cuda)
    be.spiking_linear(p, xc, part="row")  # K5's scratch is allocated once
    n = (KB.LAUNCHES["aimc_matmul_counts"], KB.LAUNCHES["lif"])
    got, seen = dispatched_ops(lambda: be.spiking_linear(p, xc, part="row"))
    assert (KB.LAUNCHES["aimc_matmul_counts"], KB.LAUNCHES["lif"]) == (
        n[0] + 1, n[1] + 1)
    assert [f for f in seen
            if not f.startswith(("aten.empty", "aten.view"))] == []
    want = KREF.aimc_spiking_linear_ref(x.reshape(4, 3, 64), lv, sc, bi)
    _eq(got, want.reshape(4, 3, 1, 48))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", [(4, 4, 256), (4, 1, 256), (3, 5, 1001)])
def test_lif_counts_kernel(cuda, shape, bias):
    """The row-parallel epilogue in one K4 launch (``counts * scale``, ``+
    bias``, LIF) equals its plain version; dyadic scales and biases put
    membranes on the threshold; a ragged width takes one column a
    thread."""
    t, m, n = shape
    rng = np.random.default_rng(n + bias)
    counts = _t(rng.integers(-40, 41, shape).astype(np.float32))
    scale = _t((rng.integers(1, 4, n) / 32.0).astype(np.float32))
    b = _t((rng.integers(-4, 9, n) / 8.0).astype(np.float32)) if bias else None
    want = KREF.lif_counts_ref(counts, scale, b)
    k = KB.LAUNCHES["lif"]
    got = KL.lif_counts_kernel(counts.to(cuda), scale.to(cuda),
                               None if b is None else b.to(cuda))
    torch.cuda.synchronize()
    assert KB.LAUNCHES["lif"] == k + 1
    _eq(got, want)
    assert 0 < int(want.sum()) < want.numel()


LAYER_CASES = {
    # name: (t, b, d, h, kv, hd, l, dff, pos, with_tail, with_mlp)
    "main_path": (4, 8, 256, 4, 4, 64, 256, 1024,
                  [0, 1, 40, 100, 200, 254, 255, 17], True, True),
    "padding": (4, 3, 64, 4, 4, 16, 24, 128, [0, 9, 23], True, True),
    "gqa": (4, 2, 256, 4, 2, 64, 64, 512, [5, 63], True, True),
    "masked_write": (2, 3, 48, 2, 2, 16, 24, 64, [24, 3, 30], True, True),
    "no_mlp": (3, 2, 64, 2, 1, 32, 40, 64, [1, 39], True, False),
    "no_tail": (4, 2, 64, 4, 4, 16, 24, 128, [7, 0], False, True),
    # one slot (one cluster) and more slots than fill the card at once:
    # pos = 0 and pos = L, GQA, the tail off and the FFN off
    "b1": (4, 1, 256, 4, 4, 64, 256, 1024, [200], True, True),
    "b13_gqa": (4, 13, 256, 4, 2, 64, 64, 1024,
                [0, 64, 1, 63, 31, 32, 33, 7, 64, 50, 0, 12, 40], True, True),
    "b13_no_tail": (4, 13, 128, 4, 1, 32, 40, 256,
                    [0, 40, 3, 39, 17, 1, 2, 38, 20, 11, 0, 9, 40], False,
                    True),
    "b13_no_mlp": (4, 13, 128, 2, 2, 64, 48, 256,
                   [5, 48, 0, 47, 10, 20, 30, 40, 1, 2, 3, 4, 6], True,
                   False),
    # d, d_ff and hd not multiples of 4: byte loads, no four-row counts
    "ragged": (3, 3, 50, 2, 1, 18, 40, 30, [0, 17, 40], True, True),
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


@pytest.mark.parametrize("case", ["b1", "b13_gqa", "b13_no_tail"])
def test_fused_layer_kernel_runs_clusters_of_the_plan(cuda, case):
    """With the placement probe every block of the grid reports a cluster
    of the plan's size, the clusters number the slots, each of a cluster's
    blocks names its cluster's index; the outputs are those of a launch
    without the probe."""
    t, b, d, h, kv, hd, l, dff, pos, tail, mlp = LAYER_CASES[case]
    head, ws, draws = layer_inputs(np.random.default_rng(len(case)), t, b, d,
                                   h, kv, hd, l, dff, pos)
    args = [*(a.to(cuda) for a in head), *(_to(w, cuda) for w in ws),
            *(a.to(cuda) for a in draws)]
    kw = dict(hd=hd, with_tail=tail, with_mlp=mlp)
    n = b * KFD.CLUSTER
    placement = torch.full((n, 3), -1, dtype=torch.int32, device=cuda)
    got = KFD.fused_decode_layer_kernel(*args, **kw, placement=placement)
    want = KFD.fused_decode_layer_kernel(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _eq(g, w)
    sm, size, cid = placement.cpu().T
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert ((sm >= 0) & (sm < sms)).all()
    assert (size == KFD.CLUSTER).all()
    assert torch.equal(cid, torch.arange(n) // KFD.CLUSTER)
    with pytest.raises(ValueError, match="placement"):
        KFD.fused_decode_layer_kernel(*args, **kw, placement=placement[1:])


@pytest.mark.parametrize("paged", [False, True])
def test_fused_layer_kernel_residual_past_int8(cuda, paged):
    """A residual past [-128, 127] is counted in int32 (the four-row int8
    counts take it only where every value fits): K3 and K9 equal their
    plain versions with residual values up to +-400, and with one slot's
    residual just past int8."""
    t, b, d, h, kv, hd, pl, mp, dff = 4, 3, 128, 2, 2, 64, 8, 4, 256
    pos = [5, 31, 12]
    rng = np.random.default_rng(400 + paged)
    head, ws, draws = layer_inputs(rng, t, b, d, h, kv, hd, mp * pl, dff, pos)
    for lo, hi in ((-400, 401), (-128, 129)):
        s = rng.integers(lo, hi, (t, b, d)).astype(np.float32)
        s[:, 0] = np.clip(s[:, 0], -128, 127)
        head[0] = _t(s)
        if paged:
            table, write, kp, vp = paged_inputs(rng, b=b, t=t, kv=kv, hd=hd,
                                                pl=pl, mp=mp, pos=pos)
            args = [head[0], kp, vp, table, head[3], write]
            fn = KFD.fused_decode_layer_paged_kernel
        else:
            args, fn = head, KFD.fused_decode_layer_kernel
        want = fn(*args, *ws, *draws, hd=hd)
        got = fn(*(a.to(cuda) for a in args), *(_to(w, cuda) for w in ws),
                 *(a.to(cuda) for a in draws), hd=hd)
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


def paged_inputs(rng, *, b, t, kv, hd, pl, mp, pos, idle=(), n_extra=4):
    """Page tables, write pages and pools under the serving invariants:
    each active slot owns the pages of blocks ``0 .. pos // pl`` (slot 1's
    block 0 is slot 0's, a shared prefix, where both are past it), rows at
    and after ``pos`` and the null page are zero, idle slots hold a null
    row and write the trash page (garbage)."""
    table = np.full((b, mp), NULL_PAGE, np.int32)
    write = np.full((b,), TRASH_PAGE, np.int32)
    nxt = RESERVED_PAGES
    for i in range(b):
        if i in idle:
            continue
        for j in range(min(pos[i] // pl, mp - 1) + 1):
            table[i, j] = nxt
            nxt += 1
        if pos[i] < mp * pl:
            write[i] = table[i, pos[i] // pl]
    if b > 1 and min(pos[0], pos[1]) >= pl and 1 not in idle:
        table[1, 0] = table[0, 0]
    n_pages = nxt + n_extra
    perm = np.arange(n_pages)
    perm[RESERVED_PAGES:] = rng.permutation(perm[RESERVED_PAGES:])
    table = np.where(table >= RESERVED_PAGES, perm[table], table)
    write = np.where(write >= RESERVED_PAGES, perm[write], write)
    shape = (n_pages, t, kv, pl, hd)
    kp = (rng.random(shape) < 0.5).astype(np.uint8)
    vp = (rng.random(shape) < 0.5).astype(np.uint8)
    kp[NULL_PAGE] = vp[NULL_PAGE] = 0
    for i, p in enumerate(pos):
        for j, pid in enumerate(table[i]):
            if pid >= RESERVED_PAGES:
                kp[pid, :, :, min(max(p - j * pl, 0), pl):] = 0
                vp[pid, :, :, min(max(p - j * pl, 0), pl):] = 0
    return [_t(a) for a in (table.astype(np.int32), write.astype(np.int32),
                            kp, vp)]


K7_CASES = {
    # name: (b, t, h, kv, d, pl, mp, pos)
    "serving_widths": (8, 4, 4, 4, 64, 8, 32, [40, 100, 0, 5, 200, 255, 17, 64]),
    "gqa_pl5": (3, 4, 4, 2, 16, 5, 5, [3, 24, 9]),
}


@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_ssa_decode_paged_kernel(cuda, case):
    b, t, h, kv, d, pl, mp, pos = K7_CASES[case]
    rng = np.random.default_rng(len(case))
    table, _, kp, vp = paged_inputs(rng, b=b, t=t, kv=kv, hd=d, pl=pl, mp=mp,
                                    pos=[p + 1 for p in pos])
    q = _t(rng.integers(0, 2, (b, t, h, d)).astype(np.uint8))
    rs = _t(rng.integers(0, d, (b, t * h, 1, mp * pl)).astype(np.int32))
    ra = _t(rng.integers(0, mp * pl, (b, t * h, 1, d)).astype(np.int32))
    args = (q, kp, vp, table, rs, ra)
    want = KS.ssa_decode_paged_kernel(*args)
    n = KB.LAUNCHES["ssa_decode_paged"]
    got = KS.ssa_decode_paged_kernel(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert KB.LAUNCHES["ssa_decode_paged"] == n + 1
    _eq(got, want)


PAGED_KEYED_CASES = {
    # name: (b, t, h, kv, d, pl, mp, pos (write positions), idle, h0, i_max):
    # the unfused paged decode at the serving widths; pos 0, mid-page, L - 1,
    # L and past L; idle slots (null rows, pos 0); a slot whose table is
    # mostly null pages; GQA with page_len 5 and a head offset; ragged D
    "serving_widths": (8, 4, 4, 4, 64, 8, 32, [40, 100, 0, 5, 200, 255, 17, 64],
                       (6,), 0, 256),
    "pos_edges": (5, 4, 4, 4, 64, 8, 4, [0, 12, 31, 32, 39], (), 0, 32),
    "idle_null": (4, 4, 4, 4, 64, 8, 32, [0, 2, 0, 9], (0, 2), 0, 256),
    "gqa_pl5_h0": (4, 4, 4, 2, 16, 5, 5, [3, 24, 9, 30], (2,), 2, 25),
    "ragged_d": (3, 3, 3, 3, 40, 7, 5, [6, 20, 34], (), 1, 20),
}


def paged_keyed_inputs(rng, b, t, h, kv, d, pl, mp, pos, idle):
    """Pools after the step's scatter: each active slot's rows up to and
    including its write position live, later rows zero; plus ``q`` and
    distinct slot keys."""
    table, _, kp, vp = paged_inputs(
        rng, b=b, t=t, kv=kv, hd=d, pl=pl, mp=mp,
        pos=[min(p + 1, mp * pl) for p in pos], idle=idle)
    q = _t(rng.integers(0, 2, (t, b, h, 1, d)).astype(np.uint8))
    keys = prng.key_from_seeds(_t(rng.integers(0, 2 ** 32, b, dtype=np.uint64)
                                  .astype(np.int64)))
    return q, kp, vp, table, keys


@pytest.mark.parametrize("case", sorted(PAGED_KEYED_CASES))
def test_ssa_decode_paged_keyed_kernel(cuda, case):
    """The K7 that draws its own comparators, reading the pools through the
    table up to each slot's write position, equals its plain version (the
    threefry twin's draws, then ``ssa_decode_paged_ref`` over every row);
    with ones written into every row past the live length it still does
    (it never reads them); without ``pos`` it reads every row."""
    b, t, h, kv, d, pl, mp, pos, idle, h0, i_max = PAGED_KEYED_CASES[case]
    rng = np.random.default_rng(sum(pos) + d)
    q, kp, vp, table, keys = paged_keyed_inputs(rng, b, t, h, kv, d, pl, mp,
                                                pos, idle)
    want = KREF.ssa_decode_paged_keyed_ref(q, kp, vp, table, keys, h0,
                                           i_max=i_max)
    tpos = _t(np.int32(pos)).to(cuda)
    dev = [x.to(cuda) for x in (q, kp, vp, table, keys)]
    n = KB.LAUNCHES["ssa_decode_paged"]
    got = KS.ssa_decode_paged_keyed_kernel(*dev, tpos, h0=h0, i_max=i_max)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["ssa_decode_paged"] == n + 1
    _eq(got, want)
    assert 0 < int(want.sum()) < want.numel()
    for i in idle:
        assert int(got[:, i].sum()) == 0
    jk, jv = kp.clone(), vp.clone()
    for i, p in enumerate(pos):
        for j, pid in enumerate(table[i].tolist()):
            if pid >= RESERVED_PAGES:
                lo = min(max(p + 1 - j * pl, 0), pl)
                jk[pid, :, :, lo:] = 1
                jv[pid, :, :, lo:] = 1
    _eq(KS.ssa_decode_paged_keyed_kernel(dev[0], jk.to(cuda), jv.to(cuda),
                                         *dev[3:], tpos, h0=h0, i_max=i_max),
        want)
    _eq(KS.ssa_decode_paged_keyed_kernel(*dev, None, h0=h0, i_max=i_max),
        want)


def test_paged_keyed_decode_row_dispatches_no_torch_op(cuda):
    """On the card the unfused paged path's decode row (``CudaBackend.
    decode_attention`` over ``KVView.from_pool(..., pos)``) is the one K7
    launch: no threefry-twin op, no copy of q or the pools, nothing but
    the output's allocation reaches PyTorch's dispatcher."""
    from repro_torch.kernels.plan import AttnSpec, KVView

    b, t, h, kv, d, pl, mp, pos, idle, h0, i_max = PAGED_KEYED_CASES[
        "serving_widths"]
    q, kp, vp, table, keys = (x.to(cuda) for x in paged_keyed_inputs(
        np.random.default_rng(3), b, t, h, kv, d, pl, mp, pos, idle))
    view = KVView.from_pool(kp, vp, table, _t(np.int32(pos)).to(cuda))
    got, seen = dispatched_ops(lambda: CudaBackend().decode_attention(
        view, q, AttnSpec(i_max, h0), slot_keys=keys))
    assert [f for f in seen if not f.startswith("aten.empty")] == []
    _eq(got, KREF.ssa_decode_paged_keyed_ref(q, kp, vp, table, keys, h0,
                                             i_max=i_max))


PAGED_LAYER_CASES = {
    # name: (t, b, d, h, kv, hd, pl, mp, dff, pos, idle[, tail, mlp])
    "serving_widths": (4, 8, 256, 4, 4, 64, 8, 32, 1024,
                       [40, 100, 0, 5, 200, 255, 17, 64], (6,)),
    "gqa_pl5": (4, 3, 64, 4, 2, 16, 5, 5, 128, [7, 25, 3], ()),
    "trash_and_past_end": (2, 4, 48, 2, 2, 16, 8, 3, 64, [24, 9, 0, 30],
                           (2,)),
    # one slot, and 13 slots with idle ones writing the trash page, pos = 0
    # and pos = L, GQA, the tail off and the FFN off
    "b1": (4, 1, 256, 4, 4, 64, 8, 32, 1024, [131], ()),
    "b13_gqa": (4, 13, 256, 4, 2, 64, 8, 8, 1024,
                [0, 64, 9, 63, 31, 32, 33, 7, 64, 50, 0, 12, 40], (3, 11)),
    "b13_no_tail": (4, 13, 128, 4, 1, 32, 5, 8, 256,
                    [0, 40, 3, 39, 17, 1, 2, 38, 20, 11, 0, 9, 40], (5,),
                    False, True),
    "b13_no_mlp": (4, 13, 128, 2, 2, 64, 8, 6, 256,
                   [5, 48, 0, 47, 10, 20, 30, 40, 1, 2, 3, 4, 6], (0, 12),
                   True, False),
}


@pytest.mark.parametrize("case", sorted(PAGED_LAYER_CASES))
def test_fused_layer_paged_kernel(cuda, case):
    t, b, d, h, kv, hd, pl, mp, dff, pos, idle, *flags = \
        PAGED_LAYER_CASES[case]
    tail, mlp = flags or (True, True)
    rng = np.random.default_rng(100 + len(case))
    table, write, kp, vp = paged_inputs(rng, b=b, t=t, kv=kv, hd=hd, pl=pl,
                                        mp=mp, pos=pos, idle=idle)
    s = _t(rng.integers(0, 3, (t, b, d)).astype(np.float32))
    ws = [_triple(rng, d, h * hd), _triple(rng, d, kv * hd, bias=False),
          _triple(rng, d, kv * hd), _triple(rng, h * hd, d),
          _triple(rng, d, dff), _triple(rng, dff, d, bias=False)]
    rs = _t(rng.integers(0, hd, (b, t, h, mp * pl)).astype(np.int32))
    ra = _t(rng.integers(0, mp * pl, (b, t, h, hd)).astype(np.int32))
    head = [s, kp, vp, table, _t(np.asarray(pos, np.int32)), write]
    kw = dict(hd=hd, with_tail=tail, with_mlp=mlp)
    want = KFD.fused_decode_layer_paged_kernel(*head, *ws, rs, ra, **kw)
    got = KFD.fused_decode_layer_paged_kernel(
        *(a.to(cuda) for a in head), *(_to(w, cuda) for w in ws),
        rs.to(cuda), ra.to(cuda), **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _eq(g, w)


def test_reduced_paged_serving_on_card_matches_cpu(cuda):
    """The reduced spiking GPT served paged on the card (K9 on every step,
    K7 under the unfused plan) gives the tokens of the plain versions on
    the CPU, and of dense serving."""
    cfg = reduced_config("xpikeformer-gpt-4-256")
    shared = list(range(3, 20))
    # the second shared prompt is admitted after the first published a page
    prompts = [shared, [1, 2, 3, 4, 5, 6], shared[:-1] + [40], [9, 8, 7]]
    outs = {}
    for dev, backend in (("cpu", "integer"), ("cuda", "cuda")):
        eng = XpikeformerEngine.from_config(cfg, backend=backend, device=dev)
        eng.init(0)
        for kernel in ("auto", "unfused"):
            KB.reset_launches()
            outs[dev, kernel], st = eng.serve(prompts, 5, slots=2,
                                              cache_len=32, paged=True,
                                              decode_kernel=kernel)
            if dev == "cuda":
                name = ("fused_decode_layer_paged" if kernel == "auto"
                        else "ssa_decode_paged")
                assert KB.LAUNCHES[name] == cfg.num_layers * st.decode_steps
                assert st.prefix_hits > 0
        outs[dev, "dense"], _ = eng.serve(prompts, 5, slots=2, cache_len=32)
    assert len(set(map(str, outs.values()))) == 1


def test_spiking_linear_kernel_past_the_grid_row_limit(cuda):
    """More row tiles than gridDim.y's 65,535 all launch: at T = 64 a tile
    takes one row of M, so M = 70,000 rows past the limit are the
    grid-stride loop's."""
    rng = np.random.default_rng(70)
    x = _t(rng.integers(0, 4, (64, 70_000, 16)).astype(np.float32))
    w = _triple(rng, 16, 48)
    assert KA.launch_plan(64, 70_000, 16, 48).regime == "mma"
    want = KREF.aimc_spiking_linear_ref(x, *w)
    got = KA.aimc_spiking_linear_kernel(x.to(cuda), *_to(w, cuda))
    torch.cuda.synchronize()
    _eq(got, want)
    assert int(want[:, 65_535:].sum()) > 0


SSA_CASES = {
    # name: (g, n, d, causal)
    "vit": (96, 64, 64, False),  # the ViT's tile, fewer of them
    "gpt": (64, 37, 64, True),  # the paper GPT's causal tile, L = 37
    "smoke": (24, 16, 16, True),
    "tails": (8, 45, 40, False),
    "widest": (4, 512, 512, True),  # the limits: GPT's position table
}


@pytest.mark.parametrize("case", sorted(SSA_CASES))
def test_ssa_attention_kernel(cuda, case):
    g, n, d, causal = SSA_CASES[case]
    rng = np.random.default_rng(n + d)
    args = [_t((rng.random((g, n, d)) < p).astype(np.uint8))
            for p in (0.5, 0.6, 0.4)]
    args += [_t(rng.integers(0, d, (g, n, n)).astype(np.int32)),
             _t(rng.integers(0, n, (g, n, d)).astype(np.int32))]
    want = KREF.ssa_attention_ref(*args, causal=causal)
    k = KB.LAUNCHES["ssa_attention"]
    got = KS.ssa_attention_kernel(*(a.to(cuda) for a in args), causal=causal)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["ssa_attention"] == k + 1
    _eq(got, want)
    assert 0 < int(want.sum()) < want.numel()


@pytest.mark.parametrize("g,n,d,causal,design", [
    (3, 513, 64, False, "resident"), (3, 513, 64, True, "resident"),
    (2, 1024, 64, True, "resident"), (2, 2048, 512, False, "stream"),
    (2, 2048, 512, True, "stream"), (1, 1000, 2100, False, "stream")])
def test_ssa_attention_kernel_past_the_old_limits(cuda, g, n, d, causal,
                                                  design):
    """Past N, D = 512: N = 513 and 1,024 keep the resident tile; G = 2,
    N = 2,048, D = 512 (and a ragged N = 1,000, D = 2,100) need more shared
    memory than a block has and stream K and V through it in chunks."""
    assert KS.attention_plan(n, d).design == design
    rng = np.random.default_rng(n + d + causal)
    args = [_t((rng.random((g, n, d)) < p).astype(np.uint8))
            for p in (0.5, 0.6, 0.4)]
    args += [_t(rng.integers(0, d, (g, n, n)).astype(np.int32)),
             _t(rng.integers(0, n, (g, n, d)).astype(np.int32))]
    want = KREF.ssa_attention_ref(*args, causal=causal)
    got = KS.ssa_attention_kernel(*(a.to(cuda) for a in args), causal=causal)
    torch.cuda.synchronize()
    _eq(got, want)
    assert 0 < int(want.sum()) < want.numel()


# name: (t, b, h, n, d, causal, design) -- the trains are [T, B, N, H*D]
KEYED_SSA_CASES = {
    "vit": (4, 64, 6, 64, 64, False, "resident"),  # the ViT's tile, B = 64
    "gpt": (4, 64, 4, 37, 64, True, "resident"),  # the paper GPT's, L = 37
    "n513": (1, 2, 2, 513, 64, True, "resident"),
    "stream": (1, 1, 2, 2048, 512, True, "stream"),
    "n1": (3, 2, 2, 1, 64, True, "resident"),
    "ragged": (2, 3, 2, 45, 40, False, "resident"),
}


def heads_inputs(rng, t, b, h, n, d, dev):
    """q, k, v as ``spikes.heads`` hands them over: the ``[T,B,H,N,D]`` views of
    ``[T,B,N,H*D]`` trains (one query row in five from the third empty),
    and a key."""
    def train(p):
        x = _t((rng.random((t, b, n, h * d)) < p).astype(np.uint8)).to(dev)
        return x.reshape(t, b, n, h, d).movedim(-2, -3)
    q, k, v = (train(p) for p in (0.3, 0.5, 0.4))
    q[:, :, :, 2::5] = 0
    key = prng.PRNGKey(int(rng.integers(0, 2 ** 31))).to(dev)
    return q, k, v, key


@pytest.mark.parametrize("case", sorted(KEYED_SSA_CASES))
def test_ssa_attention_keyed_kernel(cuda, case):
    """The keyed K8 (comparators drawn in the kernel, the heads read in
    place) equals its plain version (the twin's draws, then
    ``ssa_attention_ref``), in both designs, causal and not; it returns the
    heads view of a ``[T,B,N,H,D]`` buffer and launches once."""
    t, b, h, n, d, causal, design = KEYED_SSA_CASES[case]
    assert KS.attention_plan(n, d).design == design
    q, k, v, key = heads_inputs(np.random.default_rng(n + d), t, b, h, n, d,
                                cuda)
    assert q.is_contiguous() == (n == 1 or h == 1)
    want = KREF.ssa_attention_keyed_ref(q, k, v, key, causal=causal)
    n0 = KB.LAUNCHES["ssa_attention_keyed"]
    got = KS.ssa_attention_keyed_kernel(q, k, v, key, causal=causal)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["ssa_attention_keyed"] == n0 + 1
    _eq(got, want)
    assert got.movedim(-3, -2).is_contiguous()
    assert 0 < int(want.sum()) < want.numel()


@pytest.mark.parametrize("b0,h0,b,h,n,d", [(4, 2, 4, 2, 256, 64),
                                            (1, 0, 2, 4, 37, 64),
                                            (0, 1, 3, 1, 2048, 512)])
def test_ssa_attention_keyed_kernel_at_an_offset(cuda, b0, h0, b, h, n, d):
    """A block of a ``[T, 8, 4]`` grid of causal tiles (a mesh rank's
    batch rows from ``b0`` and heads from ``h0``; the LM's shard, a batch
    shard, and a streamed tile) draws the whole grid's comparators: it
    equals its plain version at the offset and that block of the whole
    grid's keyed K8."""
    t = 2 if n < 2048 else 1
    bg, hg = (8, 4) if n < 2048 else (4, 2)
    q, k, v, key = heads_inputs(np.random.default_rng(b0 + h0), t, bg, hg, n,
                                d, cuda)
    sl = (slice(None), slice(b0, b0 + b), slice(h0, h0 + h))
    tile = dict(b0=b0, h0=h0, batch=bg, heads=hg)
    got = KS.ssa_attention_keyed_kernel(q[sl], k[sl], v[sl], key,
                                        causal=True, **tile)
    _eq(got, KREF.ssa_attention_keyed_ref(q[sl], k[sl], v[sl], key,
                                          causal=True, **tile))
    _eq(got, KS.ssa_attention_keyed_kernel(q, k, v, key, causal=True)[sl])
    with pytest.raises(ValueError, match="outside"):
        KS.ssa_attention_keyed_kernel(q[sl], k[sl], v[sl], key, causal=True,
                                      b0=bg - b + 1, h0=h0, batch=bg,
                                      heads=hg)


def test_ssa_attention_keyed_reads_views_and_copies_alike(cuda):
    """The same tile from the ``spikes.heads`` view and from a contiguous
    copy; its output merges through ``spikes.unheads`` without a copy."""
    from repro_torch.core.spikes import unheads

    q, k, v, key = heads_inputs(np.random.default_rng(5), 2, 3, 4, 37, 64,
                                cuda)
    got = KS.ssa_attention_keyed_kernel(q, k, v, key, causal=True)
    _eq(KS.ssa_attention_keyed_kernel(q.contiguous(), k.contiguous(),
                                      v.contiguous(), key, causal=True), got)
    merged = unheads(got)
    assert merged.shape == (2, 3, 37, 4 * 64)
    assert merged.data_ptr() == got.data_ptr()


def test_ssa_attention_keyed_refuses_what_it_cannot_read(cuda):
    """A key off the card, a float train or rows that are not contiguous
    raise before any launch."""
    q, k, v, key = heads_inputs(np.random.default_rng(6), 1, 2, 2, 32, 32,
                                cuda)
    n0 = KB.LAUNCHES["ssa_attention_keyed"]
    with pytest.raises(ValueError, match="key: expected a CUDA tensor"):
        KS.ssa_attention_keyed_kernel(q, k, v, key.cpu())
    with pytest.raises(ValueError, match="q must be uint8"):
        KS.ssa_attention_keyed_kernel(q.float(), k, v, key)
    with pytest.raises(ValueError, match="k must be uint8"):
        KS.ssa_attention_keyed_kernel(q, k.transpose(-1, -2), v, key)
    assert KB.LAUNCHES["ssa_attention_keyed"] == n0


def test_paper_ssa_dispatches_no_draw_op(cuda):
    """On the card ``CudaBackend.ssa_attention`` is the one keyed K8
    launch: no threefry-twin op and no copy of q, k or v reaches PyTorch's
    dispatcher, only the output's allocation and its heads view."""
    q, k, v, key = heads_inputs(np.random.default_rng(7), 4, 2, 6, 64, 64,
                                cuda)
    got, seen = dispatched_ops(lambda: CudaBackend().ssa_attention(
        key, q, k, v, causal=False))
    assert [f for f in seen
            if not f.startswith(("aten.empty", "aten.permute"))] == []
    _eq(got, KREF.ssa_attention_keyed_ref(q, k, v, key))


@pytest.mark.parametrize("t,m,beta", [(4, 100_003, 0.5), (3, 257, 0.25),
                                      (8, 4096, 0.75),
                                      (4, 64 * 64 * 1536, 0.5)])
def test_lif_kernel(cuda, t, m, beta):
    """Dyadic currents put membranes exactly on the threshold; the last
    case is the paper ViT's widest pre-activation (B = 64)."""
    rng = np.random.default_rng(m)
    cur = _t((rng.integers(-4, 12, (t, m)) / 8.0).astype(np.float32))
    want = KREF.lif_ref(cur, beta=beta)
    got = KL.lif_kernel(cur.to(cuda), beta=beta)
    torch.cuda.synchronize()
    _eq(got, want)
    _eq(CudaBackend().lif(cur.reshape(t, m, 1).to(cuda), beta=beta),
        want.reshape(t, m, 1))


@pytest.mark.parametrize("name", ["xpikeformer-vit-smoke",
                                  "xpikeformer-gpt-smoke"])
def test_paper_forward_kernels_equal_plain_on_card(cuda, name):
    """The paper forward (two blocks) through K1 and the keyed K8 gives the
    plain versions' logits on the card bit for bit, and the CPU's
    labels."""
    task, cfg = SPIKING_ARCHS[name]
    cfg = dataclasses.replace(cfg, depth=2)
    if task == "vit":
        x = SI.sample_batch(0, SI.ImageConfig(size=cfg.image_size), 4)["images"]
    else:
        x = MIMO.sample_batch(0, MIMO.MIMOConfig(), 4)["features"]
    key = prng.PRNGKey(5)
    out = {}
    for dev, backend in (("cuda", "cuda"), ("cuda", "integer"),
                         ("cpu", "integer")):
        eng = XpikeformerEngine.from_config(cfg, backend=backend, device=dev)
        eng.init(2)
        KB.reset_launches()
        out[dev, backend] = eng.forward(x, key).cpu()
        if backend == "cuda":
            assert KB.LAUNCHES["ssa_attention_keyed"] == cfg.depth
            assert KB.LAUNCHES["ssa_attention"] == 0
            assert KB.LAUNCHES["aimc_spiking_linear"] == 6 * cfg.depth
    assert torch.equal(out["cuda", "cuda"], out["cuda", "integer"])
    assert torch.allclose(out["cuda", "cuda"], out["cpu", "integer"],
                          rtol=0, atol=1e-4)
    assert torch.equal(out["cuda", "cuda"].argmax(-1),
                       out["cpu", "integer"].argmax(-1))


def _fold_leaf(rng, shape, dev, *, offset=0, gains=(7.0,), times=(3600.0,)):
    """One programmed leaf's K6 operands on ``dev``: levels, eps and nu as
    ``program`` draws them (``offset`` elements into a larger allocation,
    so ``offset % 4 != 0`` leaves the rows unaligned), a time and ``1 /
    gain`` per matrix cycling through ``times`` and ``gains``."""
    n = int(np.prod(shape))

    def put(x):
        buf = torch.empty(n + offset, dtype=torch.float32, device=dev)
        buf[offset:] = _t(x.astype(np.float32)).reshape(-1).to(dev)
        return buf[offset:].view(shape)

    lead = shape[:-2]
    m = int(np.prod(lead))
    tt = _t(np.resize(np.float32(times), m).reshape(lead)).to(dev)
    inv = _t((1.0 / np.resize(np.float64(gains), m)).astype(np.float32)
             .reshape(lead)).to(dev)
    return KD.FoldLeaf(put(rng.integers(-15, 16, shape)),
                       put(0.45 * rng.standard_normal(shape)),
                       put(np.maximum(0.06 + 0.02 * rng.standard_normal(shape),
                                      0)), tt, inv)


@pytest.mark.parametrize("shape", [(384, 1536), (4, 256, 1024), (300, 17)])
def test_drift_requantize_kernel(cuda, shape):
    """K6 (one leaf) equals its plain version on the card bit for bit, at
    t = 0, t < t0, an hour and a year, image gains 1 and 7 (1 / img_inv
    rounded on the card as ``aimc_device._img_gain`` rounds it), with a
    time and a gain per matrix for a stacked leaf, image and calibration
    read."""
    rng = np.random.default_rng(sum(shape))
    for t in (0.0, 10.0, 3600.0, 3.1536e7):
        for gain in (1.0, 7.0):
            leaf = _fold_leaf(rng, shape, cuda, gains=(gain, 8.0),
                              times=(t, 86400.0))
            (got,) = KD.drift_fold_kernel([leaf], t0=20.0)
            torch.cuda.synchronize()
            (want,) = KREF.drift_fold_leaves_ref([leaf], t0=20.0)
            _eq(got, want)
            _eq(KREF.img_gain_ref(leaf.img_inv),
                _t(np.resize(np.float32([gain, 8.0]), leaf.img_inv.numel())
                   .reshape(leaf.img_inv.shape)))
            _eq(KD.drift_abs_sums_kernel([leaf], t0=20.0),
                KREF.drift_abs_sums_ref([leaf], t0=20.0))


# leaf shapes of the grouped fold: the ViT's widest, the LM stack's stacked
# mlp.wi, ragged widths (rows not 16-byte aligned past the first), 2-D
FOLD_SHAPES = ((384, 1536), (4, 256, 1024), (300, 17), (3, 70, 40),
               (2, 17, 33), (64, 32), (129, 7))


@pytest.mark.parametrize("n_leaves", [1, 6, 26, 40])
def test_drift_fold_kernel_groups(cuda, n_leaves):
    """The grouped K6 over ``n_leaves`` leaves of :data:`FOLD_SHAPES` in
    turn, every third one unaligned (its operands one element into their
    allocation), a time and a gain per matrix (gains 7, 1, 8 and 7.4, which
    rounds to 7), one leaf at t = 0 (no clock): each image and each
    calibration read equals its plain version, and each call launches
    once for every 32 leaves."""
    rng = np.random.default_rng(n_leaves)
    leaves = [_fold_leaf(rng, FOLD_SHAPES[i % len(FOLD_SHAPES)], cuda,
                         offset=1 if i % 3 == 2 else 0,
                         gains=(7.0, 1.0, 8.0, 7.4),
                         times=(3600.0 * (i + 1), 10.0, 3.1536e7))
              for i in range(n_leaves)]
    leaves[-1] = leaves[-1]._replace(t_seconds=None)
    chunks = -(-n_leaves // KD.MAX_LEAVES)
    n = KB.LAUNCHES["drift_requantize"]
    got = KD.drift_fold_kernel(leaves, t0=20.0)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["drift_requantize"] == n + chunks
    for g, w in zip(got, KREF.drift_fold_leaves_ref(leaves, t0=20.0)):
        _eq(g, w)
    sums = KD.drift_abs_sums_kernel(leaves, t0=20.0)
    assert KB.LAUNCHES["drift_requantize"] == n + 2 * chunks
    _eq(sums, KREF.drift_abs_sums_ref(leaves, t0=20.0))
    assert int(sums.min()) > 0


def test_programmed_paper_forward_equal_plain_on_card(cuda):
    """The programmed paper GPT at program, after a year of drift and after
    recalibration: kernel and plain logits bitwise equal on the card; the
    lifecycle launches K6 once per leaf at programming, then once per fold
    and twice per recalibration (every leaf in one launch)."""
    name = "xpikeformer-gpt-smoke"
    _, cfg = SPIKING_ARCHS[name]
    x = MIMO.sample_batch(0, MIMO.MIMOConfig(), 4)["features"]
    key = prng.PRNGKey(5)
    eng = XpikeformerEngine.from_config(cfg, backend="cuda", device="cuda")
    eng.init(2)
    KB.reset_launches()
    eng.program(prng.PRNGKey(3))
    leaves = 2 + 6 * cfg.depth
    assert KB.LAUNCHES["drift_requantize"] == leaves
    plain = XpikeformerEngine.from_config(cfg, backend="integer",
                                          device="cuda")
    for stage in ("programmed", "drifted", "recalibrated"):
        if stage == "drifted":
            eng.drift_to(3.1536e7)
        elif stage == "recalibrated":
            eng.recalibrate()
        got = eng.forward(x, key)
        assert torch.equal(got, plain.forward(x, key, eng.params)), stage
    assert KB.LAUNCHES["drift_requantize"] == leaves + 3
    assert KB.LAUNCHES["ssa_attention_keyed"] == 3 * cfg.depth


@pytest.mark.parametrize("t,m,d_in,d_out", [(4, 4, 512, 256),
                                            (4, 4096, 384, 384),
                                            (3, 5, 130, 33)])
def test_counts_kernel(cuda, t, m, d_in, d_out):
    """K5 equals its plain version at the mesh's decode tail (4 local
    slots, 512 local MLP rows), at the ViT-sized shape and a ragged one,
    with integer-valued inputs and the full int8 range."""
    rng = np.random.default_rng(m + d_in)
    x = _t(rng.integers(0, 4, (t, m, d_in)).astype(np.float32))
    lv = _t(rng.integers(-127, 128, (d_in, d_out)).astype(np.int8))
    n = KB.LAUNCHES["aimc_matmul_counts"]
    got = KA.aimc_matmul_counts_kernel(x.to(cuda), lv.to(cuda))
    torch.cuda.synchronize()
    assert KB.LAUNCHES["aimc_matmul_counts"] == n + 1
    _eq(got, KREF.aimc_counts_ref(x, lv))


# K1/K5 past the old 8-step cap, in both regimes (few rows: the split of
# d_in; many rows: the tensor-core GEMM, T > 64 in carried chunks), at the
# ViT's MLP shapes, a wide d_in and ragged widths
CROSSBAR_SHAPES = [(9, 1, 256, 256), (9, 4, 512, 256), (9, 4096, 384, 384),
                   (16, 1, 256, 1024), (16, 4, 1024, 256),
                   (16, 4096, 384, 384), (4, 4096, 384, 1536),
                   (4, 4096, 1536, 384), (70, 3, 64, 64), (9, 7, 130, 33),
                   (4, 2176, 3072, 256), (70, 40, 130, 300)]


@pytest.mark.parametrize("t,m,d_in,d_out", CROSSBAR_SHAPES)
def test_crossbar_kernels_any_t(cuda, t, m, d_in, d_out):
    """Residual-valued spikes in [0, 17] (1 + 2 x depth 8): K1 and K5 equal
    their plain versions bit for bit."""
    rng = np.random.default_rng(t * m + d_in + d_out)
    x = _t(rng.integers(0, 18, (t, m, d_in)).astype(np.float32))
    lv, sc, bi = _triple(rng, d_in, d_out)
    sc = sc / 16
    want = KREF.aimc_spiking_linear_ref(x, lv, sc, bi)
    got = KA.aimc_spiking_linear_kernel(x.to(cuda), lv.to(cuda), sc.to(cuda),
                                        bi.to(cuda))
    torch.cuda.synchronize()
    _eq(got, want)
    assert 0 < int(want.sum()) < want.numel()
    _eq(KA.aimc_matmul_counts_kernel(x.to(cuda), lv.to(cuda)),
        KREF.aimc_counts_ref(x, lv))


@pytest.mark.parametrize("m", [1, 4096])
def test_crossbar_kernel_traps_on_a_spike_past_int8(cuda, m):
    """A spike of 200 does not fit the int8 operand: the kernel traps (in a
    child process: a trap poisons the CUDA context) instead of clamping."""
    code = textwrap.dedent(f"""
        import torch
        from repro_torch.kernels import aimc_matmul as KA
        x = torch.ones((4, {m}, 64), device="cuda")
        x[3, {m} - 1, 5] = 200.0
        lv = torch.ones((64, 32), dtype=torch.int8, device="cuda")
        KA.aimc_matmul_counts_kernel(x, lv)
        torch.cuda.synchronize()
        print("no trap")
    """)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]
                                           / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                       capture_output=True, timeout=600)
    assert r.returncode != 0 and "no trap" not in r.stdout, r.stdout
    assert "CUDA" in r.stderr or "cuda" in r.stderr, r.stderr[-2000:]


def _refused(monkeypatch, module, name, value, launch):
    """``launch`` with ``module.name`` returning ``value``: the C launcher
    must refuse the plan before any kernel runs."""
    monkeypatch.setattr(module, name, lambda *a, **k: value)
    with pytest.raises(RuntimeError, match="CUDA error"):
        launch()
    monkeypatch.undo()


@pytest.mark.parametrize("kind", ["crossbar", "attention", "layer"])
def test_launchers_take_the_wrappers_plans_at_the_budget_edge(
        cuda, monkeypatch, kind):
    """The wrappers own the launch plans (K1/K5's split, K8's design and
    shared memory, K3/K9's cluster, threads and shared memory); a C
    launcher checks a plan against its buffers.  At the edge of each budget
    the launcher takes the plan Python makes and the kernel equals its
    plain version; a plan one step past a buffer, shared memory that
    differs from the launcher's layout, or another cluster size or thread
    count, is refused."""
    rng = np.random.default_rng(227)
    if kind == "crossbar":
        # T*M = 32: 2 columns a thread fill the 64 accumulators; 8 column
        # groups, 32 row slots and a chain of 8 stage exactly 8,192 spikes
        t, m, d_in, d_out = 4, 8, 16_384, 16
        plan = KA.launch_plan(t, m, d_in, d_out)
        cpt, ncgb, chain, ksplit = plan.split
        assert plan.regime == "split" and t * m * cpt == 64
        assert (256 // ncgb) * chain * t * m == 8192
        x = _t(rng.integers(0, 18, (t, m, d_in)).astype(np.float32))
        lv, _, _ = _triple(rng, d_in, d_out)
        xc, lc = x.to(cuda), lv.to(cuda)
        _eq(KA.aimc_matmul_counts_kernel(xc, lc), KREF.aimc_counts_ref(x, lv))
        for bad in ((2 * cpt, ncgb, chain, ksplit),
                    (cpt, ncgb, 2 * chain, ksplit)):
            _refused(monkeypatch, KA, "launch_plan",
                     KA.LaunchPlan("split", bad),
                     lambda: KA.aimc_matmul_counts_kernel(xc, lc))
        return
    if kind == "attention":
        d = 1024
        n = next(n for n in range(512, 2048)
                 if KS.attention_plan(n + 1, d).design == "stream")
        plan = KS.attention_plan(n, d)
        assert plan.design == "resident" and plan.smem <= KS.SMEM_BUDGET
        for nn in (n, n + 1):
            args = [_t((rng.random((1, nn, d)) < p).astype(np.uint8))
                    for p in (0.5, 0.6, 0.4)]
            args += [_t(rng.integers(0, d, (1, nn, nn)).astype(np.int32)),
                     _t(rng.integers(0, nn, (1, nn, d)).astype(np.int32))]
            dev = [a.to(cuda) for a in args]
            _eq(KS.ssa_attention_kernel(*dev, causal=True),
                KREF.ssa_attention_ref(*args, causal=True))
            p = KS.attention_plan(nn, d)
            _refused(monkeypatch, KS, "attention_plan",
                     p._replace(smem=p.smem + 4),
                     lambda: KS.ssa_attention_kernel(*dev, causal=True))
            heads = [a.reshape(1, 1, 1, nn, d) for a in dev[:3]]
            key = prng.PRNGKey(nn).to(cuda)
            _eq(KS.ssa_attention_keyed_kernel(*heads, key, causal=True),
                KREF.ssa_attention_keyed_ref(*heads, key, causal=True))
            _refused(monkeypatch, KS, "attention_plan",
                     p._replace(smem=p.smem + 4),
                     lambda: KS.ssa_attention_keyed_kernel(*heads, key,
                                                           causal=True))
        return
    b, d, h, kv, hd, l, dff = 2, 128, 2, 1, 64, 32, 256
    t = next(t for t in range(4, 512)
             if KFD.layer_smem_bytes(t + 1, d, h, kv, hd, l, dff)
             > KFD.SMEM_BUDGET)
    for tt in (t, t + 1):
        head, ws, draws = layer_inputs(rng, tt, b, d, h, kv, hd, l, dff,
                                       [5, 31])
        dev = ([a.to(cuda) for a in head] + [_to(w, cuda) for w in ws]
               + [a.to(cuda) for a in draws])
        if tt > t:
            need = KFD.layer_smem_bytes(tt, d, h, kv, hd, l, dff)
            with pytest.raises(ValueError, match=f"T={tt} .* needs {need} "):
                KFD.fused_decode_layer_kernel(*dev, hd=hd)
            break
        for g, w in zip(KFD.fused_decode_layer_kernel(*dev, hd=hd),
                        KREF.decode_layer_ref(*head, *ws, *draws, hd=hd)):
            _eq(g, w)
        _refused(monkeypatch, KFD, "layer_smem_bytes",
                 KFD.layer_smem_bytes(t, d, h, kv, hd, l, dff) - 16,
                 lambda: KFD.fused_decode_layer_kernel(*dev, hd=hd))
        plan = KFD.layer_plan(t, d, h, kv, hd, l, dff)
        assert plan == (KFD.CLUSTER, KFD.THREADS,
                        KFD.layer_smem_bytes(t, d, h, kv, hd, l, dff))
        for bad in (plan._replace(cluster=4), plan._replace(cluster=16),
                    plan._replace(threads=128)):
            _refused(monkeypatch, KFD, "layer_plan", bad,
                     lambda: KFD.fused_decode_layer_kernel(*dev, hd=hd))


@pytest.mark.parametrize("case", ["t9", "hd544"])
def test_fused_layers_past_the_old_caps(cuda, case):
    """K3 and K9 at T = 9 (the linears count 8 steps at a time and carry
    the membrane) and K3, K9, K2 and K7 at hd = 544 (the packed query in
    dynamic shared memory)."""
    t, hd = (9, 64) if case == "t9" else (2, 544)
    b, d, h, kv, pl, mp, dff = 4, 128, 2, 1, 8, 4, 256
    pos = [3, 17, 30, 9]
    rng = np.random.default_rng(9 + hd)
    head, ws, draws = layer_inputs(rng, t, b, d, h, kv, hd, mp * pl, dff, pos)
    want = KREF.decode_layer_ref(*head, *ws, *draws, hd=hd)
    got = KFD.fused_decode_layer_kernel(
        *(a.to(cuda) for a in head), *(_to(w, cuda) for w in ws),
        *(a.to(cuda) for a in draws), hd=hd)
    for g, w in zip(got, want):
        _eq(g, w)
    table, write, kp, vp = paged_inputs(rng, b=b, t=t, kv=kv, hd=hd, pl=pl,
                                        mp=mp, pos=pos, idle=(2,))
    phead = [head[0], kp, vp, table, head[3], write]
    want = KFD.fused_decode_layer_paged_kernel(*phead, *ws, *draws, hd=hd)
    got = KFD.fused_decode_layer_paged_kernel(
        *(a.to(cuda) for a in phead), *(_to(w, cuda) for w in ws),
        *(a.to(cuda) for a in draws), hd=hd)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _eq(g, w)
    if case == "hd544":
        args = _decode_inputs(rng, 8, 40, hd)
        _eq(KS.ssa_decode_kernel(*(a.to(cuda) for a in args)),
            KREF.ssa_decode_ref(*args))
        q = _t(rng.integers(0, 2, (b, t, h, hd)).astype(np.uint8))
        rs = _t(rng.integers(0, hd, (b, t * h, 1, mp * pl)).astype(np.int32))
        ra = _t(rng.integers(0, mp * pl, (b, t * h, 1, hd)).astype(np.int32))
        args = (q, kp, vp, table, rs, ra)
        _eq(KS.ssa_decode_paged_kernel(*(a.to(cuda) for a in args)),
            KS.ssa_decode_paged_kernel(*args))


def test_two_rank_mesh_on_one_card(cuda):
    """A (1, 2) mesh of two ranks sharing the card over gloo serves the
    reduced spiking GPT's single-device tokens, dense and paged, and its
    row-parallel linears launch K5 and K4."""
    from repro_torch.distributed import jobs
    from repro_torch.launch.mesh import run_ranks

    cfg = reduced_config("xpikeformer-gpt-4-256")
    prompts = [[1, 2, 3, 4], [9, 8, 7, 6, 5, 4, 3], [100, 200]]
    eng = XpikeformerEngine.from_config(cfg, backend="cuda", device=cuda)
    eng.init(0)
    want, _ = eng.serve(prompts, 6, slots=2, cache_len=32)
    job = dict(cfg=cfg, init_seed=0, prompts=prompts,
               max_new=6, slots=2, cache_len=32, backend="cuda")
    res = run_ranks(jobs.run_jobs, (1, 2), device="cuda",
                    args=([job, dict(job, paged=True, page_len=8)],),
                    timeout_s=300)
    for dense, paged in res:
        assert dense["outputs"] == want and paged["outputs"] == want
        for r, k in ((dense, "fused_decode_layer"),
                     (paged, "fused_decode_layer_paged")):
            assert r["backend"] == "sharded[cuda]"
            for name in (k, "aimc_matmul_counts", "lif", "aimc_spiking_linear"):
                assert r["launches"][name] > 0, (k, name)


def test_two_rank_moe_mesh_on_one_card(cuda):
    """A (1, 2) mesh of two ranks sharing the card over gloo serves the
    reduced phi3.5-moe (4 experts, two a rank, the dispatch's all-to-alls
    staged through the host) with one card's tokens, no choice dropped."""
    from repro_torch.distributed import jobs
    from repro_torch.launch.mesh import run_ranks

    cfg = reduced_config("phi3.5-moe-42b-a6.6b")
    prompts = [[1, 2, 3, 4], [9, 8, 7, 6, 5, 4, 3], [100, 200]]
    eng = XpikeformerEngine.from_config(cfg, task="lm", device=cuda)
    eng.init(0)
    want, _ = eng.serve(prompts, 6, slots=2, cache_len=32)
    job = dict(cfg=cfg, init_seed=0, prompts=prompts, max_new=6, slots=2,
               cache_len=32)
    for (r,) in run_ranks(jobs.run_jobs, (1, 2), device="cuda",
                          args=([job],), timeout_s=300):
        assert r["outputs"] == want
        assert (r["moe"]["past_cap"], r["moe"]["past_c2"]) == (0, 0)
        assert sum(v["all_to_alls"] for v in r["moe"]["by_tokens"].values()) > 0


def test_every_registry_name_on_a_two_by_two_mesh_on_one_card(cuda):
    """Every registry name's reduced config on a (2, 2) mesh of four ranks
    sharing the card: the served streams equal one card's, the forward's
    logits too (a spiking stack's bit for bit, a float stack's within
    1e-5: its rows split over ``data`` meet cuBLAS at another size)."""
    from repro_torch.configs import registry
    from repro_torch.distributed import jobs
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import transformer as T

    prompts = [[1, 2, 3], [4, 5, 6, 7], [9], [3, 3]]
    rng = np.random.default_rng(0)
    todo, cases = [], []
    for arch in registry.list_archs():
        cfg = reduced_config(arch)
        todo.append(dict(cfg=cfg, init_seed=0, prompts=prompts, max_new=3,
                         slots=4, cache_len=16))
        fwd = dict(kind="forward", cfg=cfg, init_seed=0, key_seed=1)
        if cfg.frontend != "none":
            fwd["embeddings"] = rng.standard_normal(
                (4, 6, cfg.frontend_dim)).astype(np.float32)
        else:
            fwd["tokens"] = rng.integers(0, cfg.vocab_size, (4, 6))
        todo.append(fwd)
        cases.append(cfg)
    res = run_ranks(jobs.run_jobs, (2, 2), device="cuda", args=(todo,),
                    timeout_s=600)
    for i, cfg in enumerate(cases):
        eng = XpikeformerEngine.from_config(cfg, task="lm", device=cuda)
        eng.init(0)
        want = eng.serve(prompts, 3, slots=4, cache_len=16)[0]
        fwd = todo[2 * i + 1]
        batch = {k: torch.from_numpy(fwd[k]).to(cuda)
                 for k in ("tokens", "embeddings") if k in fwd}
        logits = T.forward(eng.params, batch, cfg, rng=prng.PRNGKey(1, cuda),
                           backend="cuda", remat="none")[0].float().cpu()
        for ranks in res:
            assert ranks[2 * i]["outputs"] == want, cfg.name
            got = torch.from_numpy(ranks[2 * i + 1]["logits"]).float()
            if cfg.spiking:
                assert torch.equal(got, logits), cfg.name
            else:
                assert float((got - logits).abs().max()) <= 1e-5, cfg.name


@pytest.mark.parametrize("change", [{}, {"num_kv_heads": 2},
                                    {"attention_kind": "lif"}])
def test_lm_forward_on_the_card_equals_the_plain_backend(cuda, change):
    """The LM stack's full forward (K1 on every linear, the keyed K8 causal
    on every block's tile) on the reduced config, GQA and the LIF
    attention: logits and loss equal the plain versions' on the card, bit
    for bit, with the kernels launched."""
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(reduced_config("xpikeformer-gpt-4-256"),
                              **change)
    params = T.init_params(cfg, 3, cuda)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, 41))).to(cuda)
    key = prng.PRNGKey(6, cuda)
    KB.reset_launches()
    logits, _ = T.forward(params, {"tokens": tokens[:, :-1]}, cfg, rng=key,
                          backend="cuda")
    torch.cuda.synchronize()
    assert KB.LAUNCHES["aimc_spiking_linear"] == 6 * cfg.num_layers
    assert KB.LAUNCHES["ssa_attention_keyed"] == (
        0 if cfg.attention_kind == "lif" else cfg.num_layers)
    want, _ = T.forward(params, {"tokens": tokens[:, :-1]}, cfg, rng=key,
                        backend="integer")
    _eq(logits, want)
    loss, _ = T.loss_fn(params, {"tokens": tokens}, cfg, rng=key,
                        backend="cuda")
    ploss, _ = T.loss_fn(params, {"tokens": tokens}, cfg, rng=key,
                         backend="integer")
    assert float(loss) == float(ploss)


def test_reference_train_step_on_the_card_equals_the_cpu(cuda):
    """One CT step and one HWAT step of the paper GPT (smoke config)
    through the float reference backend and AdamW, on the card and on
    the host from the same weights, batch and key (TF32 off): the losses
    within 1e-4, the updated weights within 1e-6 but for at most 0.1% of
    them, and those within twice the learning rate (a first Adam step
    moves a weight by about ``lr * sign(g)``: a gradient near zero may
    change sign with the sum order); and one LM train step with two
    microbatches and int8 state, its loss within 1e-4."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.optim import adamw as A
    from repro_torch.train import hwat as H
    from repro_torch.train import loop as L
    from repro_torch import tree as TR
    from repro_torch.core.spiking_transformer import AIMCSim, init_gpt

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SPIKING_ARCHS["xpikeformer-gpt-smoke"][1]
    batch = MIMO.sample_batch(3, MIMO.MIMOConfig(), 8)
    opt = A.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    for wmode in ("ideal", "hwat"):
        out = {}
        for dev in ("cpu", cuda):
            params = init_gpt(cfg, 0, dev)
            step = H.make_step(H.model_forward(cfg, "gpt"), opt,
                               AIMCSim(wmode=wmode))
            p, _, loss = step(params, A.init_opt_state(params, opt),
                              {k: v.to(dev) for k, v in batch.items()},
                              prng.PRNGKey(5))
            out[str(dev)] = (float(loss), [x.cpu() for x in TR.flatten(p)[0]])
        (lc, pc), (lg, pg) = out["cpu"], out[str(cuda)]
        assert np.isfinite(lg) and abs(lg - lc) <= 1e-4, (wmode, lg, lc)
        d = torch.cat([torch.abs(a - b).flatten() for a, b in zip(pc, pg)])
        assert float(d.max()) <= 2 * opt.lr
        assert float((d > 1e-6).float().mean()) <= 1e-3
    lcfg = reduced_config("xpikeformer-gpt-4-256")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, (4, 17)))
    par = ParallelConfig(microbatches=2)
    iopt = A.AdamWConfig(lr=1e-3, state_dtype="int8", warmup_steps=1)
    res = {}
    for dev in ("cpu", cuda):
        params, state = L.init_state(0, lcfg, iopt, par, device=dev)
        _, _, m = L.make_train_step(lcfg, par, iopt)(
            params, state, {"tokens": tokens.to(dev)}, prng.PRNGKey(2))
        res[str(dev)] = float(m["loss"])
    assert abs(res["cpu"] - res[str(cuda)]) <= 1e-4
