"""K3/K9's launch plan and the new-token draw rule, on the CPU.

The fused decoder-layer kernels run one thread-block cluster of
``CLUSTER`` blocks per slot; ``kernels/decode_fused.py:layer_plan`` owns
the launch (cluster size, threads, shared memory) and the C launcher
refuses any other.  Here the plan's arithmetic is held at the shapes the
dense and paged serve, the ``(2, 2)`` mesh and the edges give it, the
wrapper's argument counts against the C launchers' signatures, and the
plain twin of the rule the kernel applies to the new token's score draw
(``rs[b, t, h, pos[b]]`` where the write lands, else ``2**30``) against
the JAX package's ``_rs_at_pos`` on numpy inputs
(``tests/torch_draw_rule.py``), and the weight pointers the wrapper hands
the launcher.  The kernels themselves are held against their plain
versions on the card by ``tests/test_torch_gpu.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_fused as JKFD
from repro_torch.kernels import decode_fused as KFD

import torch_draw_rule as DR

CSRC = Path(KFD.__file__).resolve().parent / "csrc" / "decode_fused.cu"

PLAN_SHAPES = {
    # name: ((T, d, H, KV, hd, L, d_ff), segment bytes in smem_layout order:
    # residual int32 and int8; query, key, value shares; a rank's rows'
    # q, k, v, packed q and k, score words, value counts, new-token spikes,
    # attention rows; the attention / hidden train; output and hidden
    # shares; a linear's partial counts)
    # the dense and paged serve: R = 2 query rows a rank, shares of 32
    # query / key / value / d columns and 128 hidden ones
    "serve": ((4, 256, 4, 4, 64, 256, 1024),
              (4096, 1024, 128, 128, 128, 128, 128, 128, 16, 16, 64, 512, 8,
               128, 4096, 128, 512, 16384)),
    # a (2, 2) mesh rank: two heads, no FFN tail (with_tail=False)
    "mesh_rank": ((4, 256, 2, 2, 64, 256, 0),
                  (4096, 1024, 64, 64, 64, 64, 64, 64, 8, 8, 32, 256, 4, 64,
                   512, 128, 0, 16384)),
    # T = 9: five rows a rank, two 8-step passes (the partials take 8)
    "t9": ((9, 256, 4, 4, 64, 256, 1024),
           (9216, 2304, 288, 288, 288, 320, 320, 320, 40, 40, 160, 1280, 20,
            320, 9216, 288, 1152, 32768)),
    # hd = 544 (17 words), GQA, fewer rows (4) than ranks
    "hd544": ((2, 128, 2, 1, 544, 32, 256),
              (1024, 256, 272, 136, 136, 544, 544, 544, 68, 68, 4, 2176, 4,
               544, 2176, 32, 64, 8192)),
    # ragged: d and d_ff not multiples of 4, hd = 18, one step
    "ragged": ((1, 50, 2, 1, 18, 40, 30),
               (200, 50, 8, 4, 4, 18, 18, 18, 4, 4, 8, 72, 4, 18, 36, 8, 4,
                4096)),
}


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_layer_plan_arithmetic(name):
    dims, segments = PLAN_SHAPES[name]
    assert KFD.layer_smem_segments(*dims) == segments
    total = 0
    for n in segments:  # every segment starts 16-aligned
        total = (total + n + 15) // 16 * 16
    plan = KFD.layer_plan(*dims)
    assert plan == (KFD.CLUSTER, KFD.THREADS, total)
    assert plan.smem == KFD.layer_smem_bytes(*dims)
    if name == "serve":
        assert plan.smem == 27760
        # B = 8 slots: a planned grid of 64 blocks in 8 clusters
        assert 8 * plan.cluster == 64


def test_layer_plan_refuses_past_the_budget():
    """At the serve widths T = 70 fits the card's 227 KB a block and T = 71
    does not: the plan names T and the bytes."""
    widths = (256, 4, 4, 64, 256, 1024)
    assert KFD.layer_plan(70, *widths).smem == 231728 <= KFD.SMEM_BUDGET
    need = KFD.layer_smem_bytes(71, *widths)
    assert need == 234832 > KFD.SMEM_BUDGET
    with pytest.raises(ValueError, match=f"T=71 .* needs {need} bytes"):
        KFD.layer_plan(71, *widths)


@pytest.mark.parametrize("n", [1, 3, 4, 16, 31, 32, 33, 50, 128, 544, 1024,
                               1089])
def test_rank_shares_cover_every_column(n):
    """Each rank owns a multiple of 4 columns (a word of int8 levels never
    straddles two ranks) and the cluster's shares cover all n."""
    sh = KFD._share(n)
    assert sh % 4 == 0
    owned = [max(0, min(n, (r + 1) * sh) - r * sh) for r in range(KFD.CLUSTER)]
    assert sum(owned) == n and all(o >= 0 for o in owned)


def _c_args(name):
    """(pointer, int) parameters of an ``extern "C"`` launcher, before
    ``beta, vth, smem, stream``, with XPK_WEIGHT_PARAMS's 18 pointers."""
    src = CSRC.read_text()
    sig = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src,
                    re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    params = [p for p in params if p]
    n_ptr = sum("*" in p for p in params) + 18 * ("XPK_WEIGHT_PARAMS" in sig)
    n_int = sum(re.match(r"int \w+$", p) is not None for p in params)
    tail = params[-4:]
    assert [t.split()[0] for t in tail] == ["float", "float", "long", "void*"]
    return n_ptr - 1, n_int  # the stream is the tail's


@pytest.mark.parametrize("name", sorted(KFD.LAUNCHERS))
def test_launcher_argument_counts(name):
    assert _c_args(name) == KFD.LAUNCHERS[name]


def _paged_case(rng, b, mp, pl):
    """Tables, write pages and positions as the paged server holds them:
    active slots own their blocks' pages and write the page at pos; idle
    slots (and slots past the end) write the trash page 1."""
    table = np.zeros((b, mp), np.int32)
    write = np.ones((b,), np.int64)
    pos = rng.integers(0, mp * pl + 6, b).astype(np.int32)
    pos[:4] = [0, mp * pl - 1, mp * pl, mp * pl + 5]
    nxt = 2
    for i in range(b):
        if i % 5 == 4:  # idle
            continue
        for j in range(min(pos[i] // pl, mp - 1) + 1):
            table[i, j] = nxt
            nxt += 1
        if pos[i] < mp * pl:
            write[i] = table[i, pos[i] // pl]
    write[6] = table[6, 0] if pos[6] >= pl else 1  # a stale write page
    return table, write, pos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_new_token_draw_matches_jax(seed):
    """The plain twin of the kernel's new-token draw against the JAX
    package's ``_rs_at_pos`` under the dense (``pos < L``) and paged
    (``pos < L`` and the table's page at pos is the write page) rules."""
    rng = np.random.default_rng(seed)
    b, t, h, mp, pl = 11, 3, 4, 5, 8
    l = mp * pl
    rs4 = rng.integers(0, 64, (b, t, h, l)).astype(np.int32)
    table, write, pos = _paged_case(rng, b, mp, pl)
    jpos = jnp.asarray(pos)
    want = JKFD._rs_at_pos(jnp.asarray(rs4), jpos, jpos < l)
    got = DR.new_token_draw(torch.from_numpy(rs4), torch.from_numpy(pos))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[pos >= l] == 2 ** 30).all()
    jt = jnp.asarray(table)
    reach = jnp.take_along_axis(
        jt, jnp.clip(jpos // pl, 0, mp - 1)[:, None], axis=1)[:, 0]
    want = JKFD._rs_at_pos(jnp.asarray(rs4), jpos,
                           (jpos < l) & (reach == jnp.asarray(write)))
    for wdt in (np.int64, np.int32):
        got = DR.new_token_draw(
            torch.from_numpy(rs4), torch.from_numpy(pos),
            torch.from_numpy(table), torch.from_numpy(write.astype(wdt)), pl)
        assert np.array_equal(got.numpy(), np.asarray(want))
    masked = np.asarray(want)[:, 0, 0] == 2 ** 30
    assert masked.any() and not masked.all()


def test_weight_pointers(monkeypatch):
    """The wrapper checks and converts a layer's weights on every call: a
    scale or bias of another dtype is converted to f32 (the copy is handed
    back to be held over the launch), a null bias is a null pointer, and
    the triples a step does not use are nulls and are not checked."""
    checked = []
    monkeypatch.setattr(KFD.KB, "check_cuda",
                        lambda t, dtype, shape, what: checked.append(what))
    rng = np.random.default_rng(0)

    def triple(di, do, bias=True):
        return (torch.from_numpy(rng.integers(-15, 16, (di, do)).astype(np.int8)),
                torch.ones(do, dtype=torch.float64),  # converted to f32
                torch.zeros(do) if bias else None)

    ws = [triple(8, 8), triple(8, 4, False), triple(8, 4), triple(8, 8),
          triple(8, 16), triple(16, 8, False)]
    dims = ((8, 8), (8, 4), (8, 4), (8, 8), (8, 16), (16, 8))
    tri, ptrs = KFD._weight_ptrs(ws, dims, True, True)
    assert len(checked) == 16 and len(ptrs) == 18
    assert ptrs[5] == 0 and ptrs[17] == 0  # no bias: a null pointer
    for w, got in zip(ws, tri):
        assert got[0] is w[0]  # int8 levels pass as they are
        assert got[1].dtype == torch.float32
        assert torch.equal(got[1], w[1].float())
        assert (got[2] is None) == (w[2] is None)
    assert ptrs[0] == ws[0][0].data_ptr() and ptrs[1] == tri[0][1].data_ptr()
    assert KFD._weight_ptrs(ws, dims, True, True)[1][:1] == ptrs[:1]
    assert len(checked) == 32  # every call checks again
    # without the tail only Q/K/V are checked, and the rest are nulls
    tri, p3 = KFD._weight_ptrs(ws, dims, False, False)
    assert len(checked) == 32 + 8 and p3[9:] == [0] * 9
    assert tri[3:] == [None] * 3
