"""The port's block-paged serving against the JAX package, on the CPU.

On numpy-seeded inputs and the reduced ``xpikeformer-gpt-4-256``:

* ``PagePool`` guard rails and prefix LRU, twin for twin with
  ``repro.serving.PagePool``; the pool surgery helpers (copy-on-write page
  copy, page zeroing) equal the reference's;
* K7's wrapper (plain path) equals ``repro.kernels.ops.
  ssa_attention_decode_paged_packed`` running the Pallas kernel in
  interpret mode, with GQA, a ``page_len`` that is not a multiple of 32 and
  null pages, also through the unfused path's view carrying each slot's
  write position (idle slots, ``pos >= L``); K9's wrapper equals ``repro.kernels.decode_fused.
  fused_decode_layer_paged`` (interpret mode) with the pool zero at and
  after ``pos``, an idle slot writing the trash page and ``pos >= L``;
* ``paged_decode_step``: pool and activity exact, logits within
  ``LOGITS_ATOL`` (layernorm and the unembed round differently in XLA and
  PyTorch);
* the paged ``BatchScheduler``'s token streams and page statistics equal
  JAX's ``BatchScheduler(paged=True)`` on the integer backend under prefix
  hits, a partial-block copy-on-write, head-of-line blocking on page
  pressure and ``evict(requeue=True)``, with the fused plan and the
  unfused one; paged serving equals dense serving
  within the port.

All comparisons are exact unless a tolerance is named.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.engine import IntegerBackend as JIntegerBackend
from repro.kernels import decode_fused as JKFD
from repro.kernels import ops as JKOPS
from repro.kernels.plan import AttnSpec as JAttnSpec
from repro.kernels.plan import KVView as JKVView
from repro.kernels.plan import build_decode_plan as j_build_decode_plan
from repro.models import transformer as JT
from repro.serving import BatchScheduler as JBatchScheduler
from repro.serving import PagePool as JPagePool
from repro.serving import state as JST
from repro_torch import convert
from repro_torch.configs import registry as R
from repro_torch.engine import XpikeformerEngine, get_backend
from repro_torch.kernels import decode_fused as KFD
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels.plan import AttnSpec, KVView, build_decode_plan
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.serving import (NULL_PAGE, RESERVED_PAGES, TRASH_PAGE,
                                 BatchScheduler, PagePool)
from repro_torch.serving import state as ST

ARCH = "xpikeformer-gpt-4-256"
LOGITS_ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _tkeys(jkeys):
    return _t(np.asarray(jkeys).astype(np.int64))


def _keys(seeds):
    return jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))


def _eq(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want.astype(got.dtype)), (
        f"{np.sum(got != want)} of {got.size} elements differ")


@pytest.fixture(scope="module")
def setup():
    cfg = JR.reduced_config(ARCH)
    jparams = JT.init_params(jax.random.PRNGKey(0), cfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return cfg, R.reduced_config(ARCH), jparams, tparams


# ---------------------------------------------------------------------------
# PagePool twins
# ---------------------------------------------------------------------------

POOLS = pytest.mark.parametrize("pool_cls", [JPagePool, PagePool],
                                ids=["reference", "port"])


@POOLS
def test_pagepool_double_free_raises(pool_cls):
    pool = pool_cls(8, 8)
    pid = pool.alloc()
    assert pool.release(pid) is True
    with pytest.raises(ValueError, match="double free"):
        pool.release(pid)


@POOLS
def test_pagepool_use_after_free_raises(pool_cls):
    pool = pool_cls(8, 8)
    pid = pool.alloc()
    pool.release(pid)
    with pytest.raises(ValueError, match="use-after-free"):
        pool.retain(pid)


@POOLS
def test_pagepool_reserved_pages_are_immortal(pool_cls):
    pool = pool_cls(8, 8)
    for pid in (NULL_PAGE, TRASH_PAGE):
        with pytest.raises(ValueError):
            pool.release(pid)
        with pytest.raises(ValueError):
            pool.retain(pid)
    with pytest.raises(ValueError, match="reserved"):
        pool_cls(RESERVED_PAGES, 8)


@POOLS
def test_pagepool_reservations_gate_alloc(pool_cls):
    pool = pool_cls(RESERVED_PAGES + 3, 8)
    pool.reserve(2)
    assert pool.available() == 1
    with pytest.raises(RuntimeError, match="reservation"):
        pool.reserve(2)
    a = pool.alloc(reserved=True)
    assert pool.available() == 1 and pool.free_pages == 2
    pool.release(a)


def _prefix_trace(pool):
    """The reference test's prefix-cache sequence; returns what it saw."""
    pids = [pool.alloc() for _ in range(3)]
    chains = []
    for i, pid in enumerate(pids):
        chains.append(pool.prefix_register(("k", i), pid, chain=True))
        pool.release(pid)  # the slot drops its ref; the cache keeps the page
    seen = [pool.free_pages, pool.prefix_lookup(("k", 0)),
            pool.prefix_register(("k", 0), pids[0], chain=True)]
    pool.release(pids[0])
    seen += [pool.prefix_evict(1), pool.prefix_contains(("k", 1)),
             pool.prefix_contains(("k", 0)), pool.prefix_lookup(("x",)),
             pool.prefix_hits, pool.prefix_misses, pool.peak_in_use,
             pool.in_use, list(pool.refcount)]
    return pids, chains, seen


def test_pagepool_prefix_lru_and_refcounts_match_reference():
    jpids, jchains, jseen = _prefix_trace(JPagePool(RESERVED_PAGES + 4, 8))
    pids, chains, seen = _prefix_trace(PagePool(RESERVED_PAGES + 4, 8))
    assert (pids, chains, seen) == (jpids, jchains, jseen)
    assert seen[0] == 1 and seen[1] == (pids[0], chains[0])
    assert seen[3] == [pids[1]] and not seen[4] and seen[5]


# ---------------------------------------------------------------------------
# Pool surgery
# ---------------------------------------------------------------------------


def _random_paged_states(cfg, tcfg, rng, n_pages=6):
    jst = JST.init_paged_state(cfg, 1, 32, 8, n_pages)
    pool = jax.tree.map(
        lambda a: (rng.random(a.shape) < 0.5).astype(np.uint8), jst.pool)
    jst = jst.__class__(jax.tree.map(jnp.asarray, pool), *(
        getattr(jst, f) for f in ("page_table", "pos", "tokens", "seeds",
                                  "active")))
    tst = ST.init_paged_state(tcfg, 1, 32, 8, n_pages, "cpu")
    tst.pool = convert.params_from_numpy(pool, device="cpu")
    return jst, tst


def _pool_eq(tst, jst):
    leaves, jleaves = tst.leaves(), jax.tree.leaves(jst.pool)
    assert len(leaves) == len(jleaves) > 0
    for tl, jl in zip(leaves, jleaves):
        _eq(tl, jl)


@pytest.mark.parametrize("keep_upto", [0, 5, 8])
def test_pool_copy_page_matches_reference(setup, keep_upto):
    cfg, tcfg, _, _ = setup
    jst, tst = _random_paged_states(cfg, tcfg, np.random.default_rng(keep_upto))
    jst = JST.pool_copy_page(jst, jnp.int32(3), jnp.int32(4),
                             jnp.int32(keep_upto))
    ST.pool_copy_page(tst, 3, 4, keep_upto)
    _pool_eq(tst, jst)


def test_pool_zero_pages_matches_reference(setup):
    cfg, tcfg, _, _ = setup
    jst, tst = _random_paged_states(cfg, tcfg, np.random.default_rng(9))
    jst = JST.pool_zero_pages(jst, jnp.asarray([2, 5, TRASH_PAGE], jnp.int32))
    ST.pool_zero_pages(tst, [2, 5, TRASH_PAGE])
    _pool_eq(tst, jst)
    assert int(tst.leaves()[0][:, 2].sum()) == 0


# ---------------------------------------------------------------------------
# K7 and K9 wrappers against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _paged_layout(rng, *, b, mp, pl, pos, idle=(), share=False):
    """Page tables and write pages under the serving invariants: each
    active slot owns the pages of its blocks ``0 .. pos // pl`` (the write
    page among them, capped at the table's end), block 0 of slot 1 can
    share slot 0's (a full prefix block), idle slots hold a null row and
    write the trash page.  Returns ``(table, write_pids, n_pages)``."""
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
    if share:  # slot 1's first full block is slot 0's page
        assert min(pos[0], pos[1]) >= pl
        table[1, 0] = table[0, 0]
    perm = rng.permutation(np.arange(RESERVED_PAGES, nxt + 2))
    remap = np.arange(nxt + 2)
    remap[RESERVED_PAGES:] = perm  # scatter pages over the pool
    table = np.where(table >= RESERVED_PAGES, remap[table], table)
    write = np.where(write >= RESERVED_PAGES, remap[write], write)
    return table.astype(np.int32), write.astype(np.int32), nxt + 2


def _paged_pools(rng, *, n_pages, t, kv, pl, hd, table, pos, fill=0.5):
    """Random spike pools, zero at and after each slot's ``pos`` (the
    serving invariant) and on the null page; the trash page is garbage."""
    shape = (n_pages, t, kv, pl, hd)
    kp = (rng.random(shape) < fill).astype(np.uint8)
    vp = (rng.random(shape) < fill).astype(np.uint8)
    kp[NULL_PAGE] = vp[NULL_PAGE] = 0
    for i, p in enumerate(pos):
        for j, pid in enumerate(table[i]):
            if pid >= RESERVED_PAGES:
                lo = min(max(p - j * pl, 0), pl)
                kp[pid, :, :, lo:] = 0
                vp[pid, :, :, lo:] = 0
    return kp, vp


K7_CASES = {
    # name: (t, b, h, kv, d, pl, mp, pos, h0)
    "gqa_pl5": (2, 3, 4, 2, 16, 5, 4, [3, 17, 9], 0),
    "pl8_d40": (2, 2, 2, 2, 40, 8, 3, [20, 6], 3),
    "mostly_null": (1, 2, 2, 1, 32, 6, 6, [2, 0], 0),
}


@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_ssa_decode_paged_wrapper_matches_pallas_interpret(case):
    t, b, h, kv, d, pl, mp, pos, h0 = K7_CASES[case]
    rng = np.random.default_rng(len(case) + d)
    table, _, n_pages = _paged_layout(rng, b=b, mp=mp, pl=pl,
                                      pos=[p + 1 for p in pos])
    kp, vp = _paged_pools(rng, n_pages=n_pages, t=t, kv=kv, pl=pl, hd=d,
                          table=table, pos=[p + 1 for p in pos])
    q = rng.integers(0, 2, (t, b, h, 1, d)).astype(np.uint8)
    keys = _keys(np.arange(b) + 11)
    want = JKOPS.ssa_attention_decode_paged_packed(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        keys, h0, i_max=mp * pl, interpret=True)
    got = KOPS.ssa_attention_decode_paged_packed(
        _t(q), _t(kp), _t(vp), _t(table), _tkeys(keys), h0, i_max=mp * pl)
    _eq(got, want)
    assert int(got.sum()) > 0
    # the dense wrapper over the gathered cache gives the same row
    kf = KOPS.gather_kv_pages(_t(kp), _t(table))
    _eq(kf, JKOPS.gather_kv_pages(jnp.asarray(kp), jnp.asarray(table)))
    vf = KOPS.gather_kv_pages(_t(vp), _t(table))
    dense = KOPS.ssa_attention_decode_packed(
        _t(q), kf.repeat_interleave(h // kv, 2), vf.repeat_interleave(h // kv, 2),
        _tkeys(keys), h0, i_max=mp * pl)
    _eq(dense, got)


@pytest.mark.parametrize("backend", ["integer", "cuda"])
def test_backend_paged_decode_attention_matches_integer(backend):
    t, b, h, kv, d, pl, mp, pos, _ = K7_CASES["gqa_pl5"]
    rng = np.random.default_rng(21)
    table, _, n_pages = _paged_layout(rng, b=b, mp=mp, pl=pl, pos=pos)
    kp, vp = _paged_pools(rng, n_pages=n_pages, t=t, kv=kv, pl=pl, hd=d,
                          table=table, pos=pos)
    q = rng.integers(0, 2, (t, b, h, 1, d)).astype(np.uint8)
    keys = _keys(np.arange(b))
    want = JIntegerBackend().decode_attention(
        JKVView.from_pool(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table)),
        jnp.asarray(q), JAttnSpec(i_max=mp * pl), slot_keys=keys)
    got = get_backend(backend).decode_attention(
        KVView.from_pool(_t(kp), _t(vp), _t(table)), _t(q),
        AttnSpec(i_max=mp * pl), slot_keys=_tkeys(keys))
    _eq(got, want)


# name: (t, b, h, kv, d, pl, mp, pos, idle, h0): the unfused serving path's
# view, each slot's write position riding it: an idle slot, a slot past L,
# a slot at L - 1, mid-page and at 0
K7_POS_CASES = {
    "idle_past_l": (2, 4, 4, 2, 16, 5, 4, [7, 0, 19, 25], (1,), 2),
    "pos0_mid": (2, 3, 2, 2, 40, 8, 3, [0, 11, 23], (), 0),
}


@pytest.mark.parametrize("case", sorted(K7_POS_CASES))
def test_paged_view_with_pos_matches_pallas_interpret(case):
    """The unfused paged path's call -- ``CudaBackend.decode_attention``
    over ``KVView.from_pool(..., pos)`` -- on the CPU (the keyed K7's plain
    version) equals JAX's paged wrapper in interpret mode, idle slots and
    slots at and past ``L`` included."""
    t, b, h, kv, d, pl, mp, pos, idle, h0 = K7_POS_CASES[case]
    rng = np.random.default_rng(sum(pos) + d)
    live = [min(p + 1, mp * pl) for p in pos]
    table, _, n_pages = _paged_layout(rng, b=b, mp=mp, pl=pl, pos=live,
                                      idle=idle)
    kp, vp = _paged_pools(rng, n_pages=n_pages, t=t, kv=kv, pl=pl, hd=d,
                          table=table, pos=live)
    q = rng.integers(0, 2, (t, b, h, 1, d)).astype(np.uint8)
    keys = _keys(np.arange(b) + 5)
    want = JKOPS.ssa_attention_decode_paged_packed(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        keys, h0, i_max=mp * pl, interpret=True)
    view = KVView.from_pool(_t(kp), _t(vp), _t(table),
                            _t(np.asarray(pos, np.int32)))
    got = get_backend("cuda").decode_attention(
        view, _t(q), AttnSpec(i_max=mp * pl, h0=h0), slot_keys=_tkeys(keys))
    _eq(got, want)
    for i in idle:
        assert int(got[:, i].sum()) == 0
    assert int(got.sum()) > 0


def _triple(rng, d_in, d_out, bias=True):
    lv = rng.integers(-15, 16, (d_in, d_out)).astype(np.int8)
    sc = (rng.random(d_out) * 0.2 + 0.01).astype(np.float32)
    bi = (rng.standard_normal(d_out) * 0.5).astype(np.float32)
    return lv, sc, (bi if bias else None)


def _jw(w):
    return tuple(None if x is None else jnp.asarray(x) for x in w)


def _tw(w):
    return tuple(None if x is None else _t(x) for x in w)


K9_CASES = {
    # name: (t, b, d, h, kv, hd, pl, mp, dff, pos, idle, share)
    "gqa_pl5": (4, 3, 64, 4, 2, 16, 5, 4, 96, [7, 12, 3], (), True),
    "trash_and_past_end": (2, 4, 48, 2, 2, 16, 8, 3, 64, [24, 9, 0, 30],
                           (2,), False),
    "serving_widths": (4, 2, 256, 4, 4, 64, 8, 4, 1024, [31, 10], (), True),
}


@pytest.mark.parametrize("case", sorted(K9_CASES))
def test_fused_layer_paged_wrapper_matches_pallas_interpret(case):
    t, b, d, h, kv, hd, pl, mp, dff, pos, idle, share = K9_CASES[case]
    rng = np.random.default_rng(200 + len(case))
    table, write, n_pages = _paged_layout(rng, b=b, mp=mp, pl=pl, pos=pos,
                                          idle=idle, share=share)
    kp, vp = _paged_pools(rng, n_pages=n_pages, t=t, kv=kv, pl=pl, hd=hd,
                          table=table, pos=pos)
    s = rng.integers(0, 3, (t, b, d)).astype(np.float32)
    ws = [_triple(rng, d, h * hd), _triple(rng, d, kv * hd, bias=False),
          _triple(rng, d, kv * hd), _triple(rng, h * hd, d),
          _triple(rng, d, dff), _triple(rng, dff, d, bias=False)]
    keys = _keys(np.arange(b) + 4)
    pos = np.asarray(pos, np.int32)
    want = JKFD.fused_decode_layer_paged(
        keys, jnp.asarray(s), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(pos), jnp.asarray(write),
        *(_jw(w) for w in ws), hd=hd, interpret=True)
    got = KFD.fused_decode_layer_paged(
        _tkeys(keys), _t(s), _t(kp), _t(vp), _t(table), _t(pos), _t(write),
        *(_tw(w) for w in ws), hd=hd)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("backend", ["integer", "cuda"])
def test_backend_paged_decode_layer_matches_integer(backend):
    t, b, d, h, kv, hd, pl, mp, dff, pos, idle, share = K9_CASES["gqa_pl5"]
    rng = np.random.default_rng(31)
    table, write, n_pages = _paged_layout(rng, b=b, mp=mp, pl=pl, pos=pos,
                                          share=share)
    kp, vp = _paged_pools(rng, n_pages=n_pages, t=t, kv=kv, pl=pl, hd=hd,
                          table=table, pos=pos)
    s = rng.integers(0, 2, (t, b, d)).astype(np.float32)
    shapes = [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d), (d, dff),
              (dff, d)]
    ws = [rng.standard_normal(sh).astype(np.float32) / np.sqrt(sh[0])
          for sh in shapes]
    keys = _keys(np.arange(b))
    pos = np.asarray(pos, np.int32)
    want = JIntegerBackend().decode_layer_fused(
        keys, jnp.asarray(s),
        JKVView.from_pool(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table)),
        jnp.asarray(pos), *(jnp.asarray(w) for w in ws), hd=hd,
        write_pids=jnp.asarray(write))
    got = get_backend(backend).decode_layer_fused(
        _tkeys(keys), _t(s), KVView.from_pool(_t(kp), _t(vp), _t(table)),
        _t(pos), *(_t(w) for w in ws), hd=hd, write_pids=_t(write))
    for g, w in zip(got, want):
        _eq(g, w)


# ---------------------------------------------------------------------------
# paged_decode_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["fused", "unfused"])
def test_paged_decode_step_matches_reference(setup, kernel):
    """One paged step from a serving-shaped pool: pool and activity
    exact, logits within ``LOGITS_ATOL``, greedy tokens equal."""
    cfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(7)
    b, pl, mp = 3, 8, 4
    pos = [13, 9, 0]
    table, write, n_pages = _paged_layout(rng, b=b, mp=mp, pl=pl, pos=pos,
                                          idle=(2,), share=True)
    jpool = JT.init_paged_pool(cfg, n_pages, pl)
    pool = {}
    for grp, blks in jpool.items():
        pool[grp] = {}
        for name, blk in blks.items():
            kp, vp = zip(*[_paged_pools(
                rng, n_pages=n_pages, t=cfg.spike_T, kv=cfg.num_kv_heads,
                pl=pl, hd=cfg.resolved_head_dim, table=table, pos=pos)
                for _ in range(blk["kp"].shape[0])])
            pool[grp][name] = {"kp": np.stack(kp), "vp": np.stack(vp)}
    tok = np.array([[3], [100], [0]], np.int32)
    seeds = np.array([11, 12, 0], np.uint32)
    args = (table, np.asarray(pos, np.int32), write)
    be = JIntegerBackend()
    jplan = j_build_decode_plan(cfg, be, layout="paged", kernel=kernel)
    jl, jpool, jact = jax.jit(lambda p, pool, *a: JT.paged_decode_step(
        p, pool, a[0], a[1], a[2], a[3], a[4], cfg, backend=be, plan=jplan))(
        jparams, jax.tree.map(jnp.asarray, pool), jnp.asarray(table),
        jnp.asarray(tok), jnp.asarray(pos, jnp.int32), jnp.asarray(seeds),
        jnp.asarray(write))
    tbe = get_backend("cuda")
    tpool = convert.params_from_numpy(pool, device="cpu")
    tl, tpool2, tact = T.paged_decode_step(
        tparams, tpool, _t(table), _t(tok.astype(np.int64)), _t(args[1]),
        _t(seeds.astype(np.int64)), _t(write), tcfg, backend=tbe,
        plan=build_decode_plan(tcfg, tbe, layout="paged", kernel=kernel))
    assert tpool2 is tpool  # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGITS_ATOL)
    _eq(tact, jact)
    for grp in tpool:
        for name in tpool[grp]:
            for leaf in ("kp", "vp"):
                _eq(tpool[grp][name][leaf], jpool[grp][name][leaf])
    assert np.array_equal(tl[:, 0].argmax(-1).numpy(),
                          np.asarray(jnp.argmax(jl[:, 0], -1)))


# ---------------------------------------------------------------------------
# The paged scheduler against JAX's
# ---------------------------------------------------------------------------


def _prompt(i, length):
    return list(range(3 + i, 3 + i + length))


def _run(sch, prompts, max_new, seed0=100):
    rids = [sch.submit(p, max_new, seed=seed0 + i)
            for i, p in enumerate(prompts)]
    outs = sch.run()
    return [list(outs[r]) for r in rids]


def _prefix_and_cow(sch):
    """Two full-block hits (the same 17-token prompt twice) and a shared
    partial tail (a 6-token prompt three times: copy-on-write)."""
    shared, tail = _prompt(7, 17), _prompt(3, 6)
    return (_run(sch, [shared], 4, seed0=1) + _run(sch, [shared], 4, seed0=2)
            + [o for s in (1, 2, 3) for o in _run(sch, [tail], 3, seed0=s)])


def _page_pressure(sch):
    """Four 2-page requests on 4 slots but 4 usable pages: admission
    waits for pages, first in first out."""
    return _run(sch, [_prompt(i, 9) for i in range(4)], 6)


def _evict_requeue(sch):
    prompts = [_prompt(i, 4 + i) for i in range(3)]
    rids = [sch.submit(p, 4, seed=100 + i) for i, p in enumerate(prompts)]
    for _ in range(2):
        sch.step()
    sch.evict(0, requeue=True)
    outs = sch.run()
    return [list(outs[r]) for r in rids]


SCENARIOS = {
    # name: (drive, slots, cache_len, n_pages)
    "prefix_and_cow": (_prefix_and_cow, 2, 32, None),
    "page_pressure": (_page_pressure, 4, 16, 6),
    "evict_requeue": (_evict_requeue, 2, 32, None),
}
STAT_FIELDS = ("decode_steps", "decoded_tokens", "prefill_tokens",
               "admissions", "evictions", "prefix_hits", "prefix_hit_tokens",
               "cow_copies", "pages_in_use_peak", "peak_active_slots")


@pytest.fixture(scope="module")
def reference_paged(setup):
    cfg, _, jparams, _ = setup
    out = {}
    for name, (drive, slots, cache_len, n_pages) in SCENARIOS.items():
        sch = JBatchScheduler(jparams, cfg, JIntegerBackend(), slots=slots,
                              cache_len=cache_len, paged=True, page_len=8,
                              n_pages=n_pages)
        out[name] = (drive(sch), sch.stats, list(sch.pages.refcount))
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_paged_scheduler_matches_reference(setup, reference_paged, scenario):
    _, tcfg, _, tparams = setup
    drive, slots, cache_len, n_pages = SCENARIOS[scenario]
    want, jst, jref = reference_paged[scenario]
    sch = BatchScheduler(tparams, tcfg, "cuda", slots=slots,
                         cache_len=cache_len, paged=True, page_len=8,
                         n_pages=n_pages, device="cpu")
    assert sch.plan.fused and sch.plan.layout == "paged"
    got = drive(sch)
    assert got == want
    for f in STAT_FIELDS:
        assert getattr(sch.stats, f) == getattr(jst, f), f
    assert sch.stats.spike_events == jst.spike_events
    assert list(sch.pages.refcount) == jref
    if scenario == "prefix_and_cow":
        assert sch.stats.prefix_hits > 0 and sch.stats.cow_copies > 0
    if scenario == "page_pressure":
        assert sch.stats.peak_active_slots < slots
    # freed pages are zero, and no slot holds a page any more
    assert (sch._table_rows == NULL_PAGE).all()
    free = np.asarray(sch.pages.refcount) == 0
    for leaf in sch.state.leaves():
        assert int(leaf.movedim(-5, 0)[torch.from_numpy(free)].sum()) == 0


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_unfused_paged_scheduler_matches_reference(setup, reference_paged,
                                                   scenario):
    """The unfused paged plan (K1 linears, the keyed K7 row over the pool
    after the scatter, each slot's write position on the view) serves JAX's
    paged scheduler's tokens and statistics."""
    _, tcfg, _, tparams = setup
    drive, slots, cache_len, n_pages = SCENARIOS[scenario]
    want, jst, jref = reference_paged[scenario]
    sch = BatchScheduler(tparams, tcfg, "cuda", slots=slots,
                         cache_len=cache_len, paged=True, page_len=8,
                         n_pages=n_pages, decode_kernel="unfused",
                         device="cpu")
    assert not sch.plan.fused and sch.plan.layout == "paged"
    assert drive(sch) == want
    for f in STAT_FIELDS:
        assert getattr(sch.stats, f) == getattr(jst, f), f
    assert sch.stats.spike_events == jst.spike_events
    assert list(sch.pages.refcount) == jref


def test_paged_equals_dense_in_the_port(setup):
    """Paged (fused and unfused plans, both backends) == dense through the
    engine facade, with admissions mid-flight and a shared prefix."""
    _, tcfg, _, tparams = setup
    eng = XpikeformerEngine.from_config(tcfg, device="cpu")
    eng.params = tparams
    prompts = [_prompt(i % 2, 9 + 3 * i) for i in range(4)] + [_prompt(0, 5)]
    dense, _ = eng.serve(prompts, 5, slots=2, cache_len=32)
    for backend, kernel in (("cuda", "auto"), ("integer", "unfused")):
        eng.backend = get_backend(backend)
        eng._schedulers.clear()
        got, st = eng.serve(prompts, 5, slots=2, cache_len=32, paged=True,
                            decode_kernel=kernel)
        assert got == dense, (backend, kernel)
        assert st.prefix_hits > 0
    sch = eng.scheduler(slots=2, cache_len=32, paged=True, decode_kernel=kernel)
    assert sch.plan.describe().startswith("DecodePlan(paged, unfused, "
                                          "page_len=8)")
    with pytest.raises(ValueError, match="could never be admitted"):
        BatchScheduler(tparams, tcfg, slots=2, cache_len=32, paged=True,
                       n_pages=4, device="cpu").submit(_prompt(0, 20), 4)
    with pytest.raises(ValueError, match="multiple of page_len"):
        BatchScheduler(tparams, tcfg, slots=2, cache_len=30, paged=True,
                       device="cpu")


def test_serve_cli_paged_on_cpu(capsys):
    """``--paged`` serves the CLI's prompts off the page pool with the
    dense run's tokens."""
    kw = dict(smoke=True, n_requests=3, slots=2, max_new=2, cache_len=32,
              device="cpu")
    dense = serve_cli.serve(ARCH, **kw)
    capsys.readouterr()
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--requests", "3", "--slots", "2", "--max-new", "2",
                    "--cache-len", "32", "--paged", "--page-len", "8",
                    "--n-pages", "12"])
    out = capsys.readouterr().out
    assert "DecodePlan(paged, fused, page_len=8)" in out
    assert "served 3 requests, 6 tokens" in out and "12 pages of 8" in out
    assert serve_cli.serve(ARCH, paged=True, **kw) == dense
