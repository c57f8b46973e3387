"""The keyed K2's and K7's in-kernel draw chains against ``jax.random``, on
the CPU.

The keyed SSA decode row (``csrc/ssa_attention.cu:ssa_decode_keyed_kernel``
with ``csrc/threefry.cuh``) derives each comparator from the slot key by
itself, element by element: no tensor of draws exists to compare on the
card.  :func:`keyed_draw` transcribes that chain as the kernel runs it --
one element ``(b, h, t, j)`` at a time, from the slot key through
``fold_in(h0 + h)``, ``split``, ``randint``'s own split and the flat index
``t * L + j`` to the two-word ``randint``, in uint32 arithmetic that
wraps -- with the multiplier the wrapper computes on the host
(``prng.randint_multiplier``).  Here it
must give JAX's ``draw_slot_decode_prns`` at the keyed row's test shapes,
so the index arithmetic the CUDA code mirrors is held on the CPU.

The keyed K8 (``ssa_attention_keyed_kernel``) draws one key's chain over
whole tiles: :func:`keyed_tile` transcribes it block by block -- randint's
four subkeys as a warp derives and shares them, each word of 32
comparators drawn only where a lane counts more than zero, the flat
indices ``(g N + i) N + j`` and ``(g N + i) D + d`` (in the streaming
design from its row block and key chunk), and the three remainders as
``xpk_fastmod`` takes them in wrapping uint64 arithmetic with the host's
``M`` -- and must give JAX's ``draw_comparator_prns`` at every element it
draws and JAX's tile.  A launch that holds a block of a larger grid of
tiles (a mesh rank's batch rows from ``b0`` and heads from ``h0``) draws
at its tiles' indices in that grid (``TileIO::draw_tile``): the same
transcription there must give JAX's draws of the whole grid and the block
of JAX's whole tile.

The keyed K7 (``ssa_decode_paged_keyed_kernel``) draws the same chain at
the logical length ``L = MP * page_len``.  :func:`paged_keyed_row`
transcribes its whole query row as the block runs it -- the live length
``pos + 1`` clamped to ``[0, L]``, each live row through the slot's table
row (the null page skipped), query head ``h`` on KV head ``h // (H/KV)``,
each comparator from :func:`keyed_draw` -- and must give JAX's paged
wrapper (the Pallas kernel in interpret mode) wherever the rows past the
live length are zero, as serving keeps them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JKOPS
from repro.kernels import ref as JREF
from repro_torch import prng
from repro_torch.kernels import ssa_attention as KS
from repro_torch.serving import NULL_PAGE, RESERVED_PAGES

M32 = 0xFFFFFFFF

# (t, b, h, l, d, h0, i_max): test_torch_kernels.py's keyed cases
CASES = {
    "prefill": (4, 1, 4, 256, 64, 0, 256),
    "slots": (2, 3, 2, 40, 16, 0, 40),
    "h0": (2, 2, 2, 24, 16, 2, 24),
    "i_max": (3, 2, 2, 32, 32, 1, 20),
    "ragged": (2, 3, 3, 33, 40, 3, 33),
    # an output span past 2**16, where randint's multiplier wraps to 0
    "wide_span": (2, 1, 2, 24, 16, 0, 70000),
}


def _cipher(key, x0, x1):
    """``xpk_threefry2x32``: the cipher itself is the twin's, which
    ``tests/test_torch_prng.py`` holds to JAX."""
    return prng.threefry2x32(key[0], key[1], x0, x1)


def keyed_draw(slot_keys, h0, b, h, t, j, length, span, which):
    """One comparator per element of the index tensors ``b, h, t, j`` (int64),
    as the kernel's thread for that element draws it: ``which`` 0 is a
    score comparator (``j`` a cache row, ``length = L``, ``span = D``), 1
    an output comparator (``j`` a value lane, ``length = D``, ``span =
    i_max``)."""
    zero = torch.zeros_like(b)
    slot = (slot_keys[b, 0], slot_keys[b, 1])
    kh = _cipher(slot, zero, (h0 + h) & M32)            # xpk_fold_in
    sub = _cipher(kh, zero, zero + which)                 # xpk_split(kh, which)
    hi = _cipher(sub, zero, zero)                         # XpkRandint::make
    lo = _cipher(sub, zero, zero + 1)
    i = t * length + j                                    # the flat index
    hb = _cipher(hi, i >> 32, i & M32)                    # xpk_random_bits
    lb = _cipher(lo, i >> 32, i & M32)
    hb, lb = hb[0] ^ hb[1], lb[0] ^ lb[1]
    mult = prng.randint_multiplier(span)                  # the host's
    off = (((hb % span) * mult & M32) + lb % span) & M32  # XpkRandint::at
    return (off % span).to(torch.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_keyed_draw_chain_equals_jax(case):
    t, b, h, l, d, h0, i_max = CASES[case]
    seeds = np.random.default_rng(b + h0).integers(0, 2 ** 32, b,
                                                   dtype=np.uint64)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds.astype(np.uint32)))
    rs, ra = JKOPS.draw_slot_decode_prns(keys, t, h, l, d, i_max, h0)
    tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    for which, (want, length, span) in enumerate(((rs, l, d),
                                                   (ra, d, i_max))):
        # every element of [B, T*H, 1, length], t-major over T*H
        bb, tt, hh, jj = (x.reshape(-1) for x in torch.meshgrid(
            torch.arange(b), torch.arange(t), torch.arange(h),
            torch.arange(length), indexing="ij"))
        got = keyed_draw(tkeys, h0, bb, hh, tt, jj, length, span, which)
        assert np.array_equal(got.reshape(b, t * h, 1, length).numpy(),
                              np.asarray(want))




# (t, b, h, kv, page_len, mp, d, h0, i_max, pos): L = MP * page_len not a
# multiple of 32, GQA, a head offset, an output span past 2**16; pos holds
# a slot at 0, mid-page, at L - 1 and past L, and an idle slot (None: a
# null table row)
PAGED_CASES = {
    "l35": (2, 3, 2, 2, 5, 7, 16, 0, 35, [0, 12, 40]),
    "gqa_h0": (2, 3, 4, 2, 8, 4, 24, 3, 32, [17, None, 31]),
    "mostly_null": (1, 2, 2, 1, 6, 6, 40, 1, 36, [2, 9]),
    "wide_span": (2, 2, 2, 1, 7, 3, 16, 2, 70000, [20, 4]),
}


def _paged_state(rng, t, b, kv, pl, mp, d, pos):
    """A pool and tables as serving holds them after the step's scatter:
    each active slot owns pages for blocks ``0 .. pos // pl`` (capped at
    the table), rows up to and including ``pos`` are live, later rows and
    the null page zero; an idle slot holds a null row."""
    table = np.full((b, mp), NULL_PAGE, np.int32)
    nxt = RESERVED_PAGES
    for i, p in enumerate(pos):
        if p is None:
            continue
        for j in range(min(p // pl, mp - 1) + 1):
            table[i, j] = nxt
            nxt += 1
    shape = (nxt + 1, t, kv, pl, d)
    kp = (rng.random(shape) < 0.5).astype(np.uint8)
    vp = (rng.random(shape) < 0.5).astype(np.uint8)
    kp[NULL_PAGE] = vp[NULL_PAGE] = 0
    for i, p in enumerate(pos):
        for j, pid in enumerate(table[i]):
            if pid >= RESERVED_PAGES:
                lo = min(max(p + 1 - j * pl, 0), pl)
                kp[pid, :, :, lo:] = 0
                vp[pid, :, :, lo:] = 0
    return table, kp, vp


def paged_keyed_row(q, kp, vp, table, pos, slot_keys, h0, i_max):
    """The keyed K7 block by block: ``q [T,B,H,1,D]``, pools ``[P,T,KV,
    page_len,D]``, ``table [B,MP]``, ``pos [B]`` -> ``[T,B,H,1,D]``."""
    t, b, h, _, d = q.shape
    kv, pl = kp.shape[2], kp.shape[3]
    length = table.shape[1] * pl
    out = torch.zeros_like(q)
    for bb in range(b):
        live = length if pos[bb] >= length else max(pos[bb] + 1, 0)
        rows = [(j, int(table[bb, j // pl])) for j in range(live)]
        rows = [(j, page) for j, page in rows if page != NULL_PAGE]
        for tt in range(t):
            for hh in range(h):
                kvh = hh // (h // kv)
                sel = lambda x, j: x[rows[j][1], tt, kvh, rows[j][0] % pl]
                idx = lambda n: torch.full((n,), 0, dtype=torch.int64)
                js = torch.tensor([j for j, _ in rows], dtype=torch.int64)
                rs = keyed_draw(slot_keys, h0, idx(len(rows)) + bb,
                                idx(len(rows)) + hh, idx(len(rows)) + tt, js,
                                length, d, 0)
                ra = keyed_draw(slot_keys, h0, idx(d) + bb, idx(d) + hh,
                                idx(d) + tt, torch.arange(d), d, i_max, 1)
                acc = torch.zeros(d, dtype=torch.int64)
                for j in range(len(rows)):
                    cnt = int((q[tt, bb, hh, 0] & sel(kp, j)).sum())
                    if cnt > int(rs[j]):
                        acc += sel(vp, j).to(torch.int64)
                out[tt, bb, hh, 0] = (acc > ra).to(torch.uint8)
    return out


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_keyed_draw_chain_equals_jax(case):
    """The keyed K7's draws element by element equal JAX's at the logical
    length, and its row, transcribed block by block, equals JAX's paged
    wrapper in interpret mode."""
    t, b, h, kv, pl, mp, d, h0, i_max, pos = PAGED_CASES[case]
    length = mp * pl
    rng = np.random.default_rng(length + d + h0)
    seeds = rng.integers(0, 2 ** 32, b, dtype=np.uint64)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds.astype(np.uint32)))
    tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    rs, ra = JKOPS.draw_slot_decode_prns(keys, t, h, length, d, i_max, h0)
    for which, (want, n, span) in enumerate(((rs, length, d), (ra, d, i_max))):
        bb, tt, hh, jj = (x.reshape(-1) for x in torch.meshgrid(
            torch.arange(b), torch.arange(t), torch.arange(h),
            torch.arange(n), indexing="ij"))
        got = keyed_draw(tkeys, h0, bb, hh, tt, jj, n, span, which)
        assert np.array_equal(got.reshape(b, t * h, 1, n).numpy(),
                              np.asarray(want))
    table, kp, vp = _paged_state(rng, t, b, kv, pl, mp, d,
                                 [0 if p is None else p for p in pos])
    table[[i for i, p in enumerate(pos) if p is None]] = NULL_PAGE
    q = rng.integers(0, 2, (t, b, h, 1, d)).astype(np.uint8)
    want = JKOPS.ssa_attention_decode_paged_packed(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        keys, h0, i_max=i_max, interpret=True)
    got = paged_keyed_row(torch.from_numpy(q), torch.from_numpy(kp),
                          torch.from_numpy(vp), table,
                          [0 if p is None else p for p in pos], tkeys, h0,
                          i_max)
    assert np.array_equal(got.numpy(), np.asarray(want))
    if i_max <= length:  # a wider output span leaves every count below it
        assert 0 < int(got.sum()) < got.numel()


# ---------------------------------------------------------------------------
# K8's keyed tile
# ---------------------------------------------------------------------------

U64 = np.uint64


def fastmod(x, m, span):
    """``xpk_fastmod`` in wrapping uint64 arithmetic: ``M * x`` wraps at 64
    bits, then ``__umul64hi`` of it and ``span`` from its two 32-bit
    halves (neither partial product can wrap for a uint32 span)."""
    low = U64(m) * np.atleast_1d(np.asarray(x, dtype=U64))
    span = U64(span)
    high = (low >> U64(32)) * span + (((low & U64(M32)) * span) >> U64(32))
    return (high >> U64(32)).astype(np.uint32)


SPANS = (1, 2, 37, 64, 65, 513, 2 ** 16 + 1, 2 ** 31 - 1)


@pytest.mark.parametrize("span", SPANS)
def test_fastmod_is_the_remainder(span):
    """Exact for the edges of uint32 and of the span, and a seeded
    sample, with the constant the wrapper passes the kernel."""
    xs = np.concatenate([
        np.array([0, 1, span - 1, span, 2 ** 32 - 1], dtype=np.uint64),
        np.random.default_rng(span).integers(0, 2 ** 32, 20_000,
                                             dtype=np.uint64)])
    got = fastmod(xs, KS.fastmod_m(span), span)
    assert np.array_equal(got.astype(np.uint64), xs % U64(span))


def tile_subkeys(key):
    """``xpk_split_randint_keys``: lane ``l < 4`` derives
    ``split(split(key)[l & 1])[l >> 1]``; the warp takes the score draws'
    higher and lower subkeys from lanes 0 and 2, the output draws' from 1
    and 3."""
    zero = torch.zeros(1, dtype=torch.int64)
    k = (zero + int(key[0]), zero + int(key[1]))
    lane = [_cipher(_cipher(k, zero, zero + (l & 1)), zero, zero + (l >> 1))
            for l in range(4)]
    return (lane[0], lane[2]), (lane[1], lane[3])


def tile_draw(sub, flat, span):
    """``XpkRandintFast::at`` at uint64 flat indices: the higher and lower
    words' cipher calls (the twin's cipher), then the three remainders by
    :func:`fastmod`, the product wrapping at 32 bits."""
    i = torch.from_numpy(flat.astype(np.int64))
    words = []
    for key in sub:
        y = _cipher(key, i >> 32, i & M32)
        words.append((y[0] ^ y[1]).numpy().astype(U64))
    m, mult = KS.fastmod_m(span), prng.randint_multiplier(span)
    h = fastmod(words[0], m, span).astype(U64)
    l = fastmod(words[1], m, span).astype(U64)
    return fastmod((h * U64(mult) + l) & U64(M32), m, span)


def nth_set_bit(m, p):
    """``nth_set_bit``: the p-th (from 0) set bit of m by a binary search
    over halves."""
    pos = 0
    for half in (16, 8, 4, 2, 1):
        low = bin(m & ((1 << half) - 1)).count("1")
        if p >= low:
            p, m, pos = p - low, m >> half, pos + half
    return pos


def warp_draws(passes, sub, span, drawn):
    """``KeyedTileDraws::draw`` over a stage's warp passes, each two words
    of 32 lanes ``(counts [64], flat [64])``: where more than 32 counts are
    not zero every lane draws its own two; where 1..32 are, lane ``e``
    draws the e-th of them (word 0's, then word 1's) and each lane takes
    its own back by a shuffle from the lane of its rank.  Returns each
    pass's 64 comparators (a lane that counts zero may hold any draw: it
    cannot fire) and records ``(flat, value)`` of every draw made for a
    counting element."""
    want, made = [], []
    for counts, flat in passes:
        m = [sum(1 << l for l in range(32) if counts[32 * c + l] > 0)
             for c in (0, 1)]
        n0 = bin(m[0]).count("1")
        n = n0 + bin(m[1]).count("1")
        if n > 32:
            at = flat
        else:  # lane e < n draws element e; lanes past n draw nothing used
            at = np.array([flat[32 * (e >= n0)]
                           + nth_set_bit(m[e >= n0], e - n0 * (e >= n0))
                           for e in range(n)], dtype=U64)
        want.append((m, n0, n, at))
        made.append(at)
    flat_all = np.concatenate(made) if made else np.zeros(0, U64)
    vals = tile_draw(sub, flat_all, span) if flat_all.size else flat_all
    out, at0 = [], 0
    for m, n0, n, at in want:
        u = vals[at0:at0 + at.size].astype(np.int64)
        at0 += at.size
        r = np.zeros(64, np.int64)
        if n > 32:
            r[:] = u
            keep = [32 * c + l for c in (0, 1) for l in range(32)
                    if m[c] >> l & 1]
        elif n:
            u = np.pad(u, (0, 32 - n))
            for l in range(32):
                below = (1 << l) - 1
                r[l] = u[bin(m[0] & below).count("1")]
                r[32 + l] = u[(n0 + bin(m[1] & below).count("1")) & 31]
            keep = list(range(n))
        if n:
            drawn.append((at[keep], u[keep].astype(np.uint32)))
        out.append(r)
    return out


def draw_tile(g, t_b_h, grid):
    """``TileIO::draw_tile``: local tile ``g`` of a launch of ``(T, B, H)``
    tiles whose block starts at ``(b0, h0)`` of a ``(Bg, Hg)`` grid ->
    its index in the grid, in uint64 arithmetic."""
    _, b, h = t_b_h
    b0, h0, bg, hg = grid
    hh, bb, tt = U64(g % h), U64(g // h % b), U64(g // h // b)
    return (tt * U64(bg) + U64(b0) + bb) * U64(hg) + U64(h0) + hh


def keyed_tile(q, k, v, key, causal, plan, tiles=None):
    """The keyed K8 block by block over ``q``/``k``/``v [G,N,D]`` (the
    tiles in ``(t, b, h)`` order) under ``plan`` (``rows == 0``: the
    resident design, a block a tile; else the streaming one, a block per
    tile and ``rows`` query rows, keys ``keys`` at a time): each warp pass
    takes two words of 32 lanes, the score stage's from the start of the
    row (of the chunk, streamed), the output stage's 64 columns at a time.
    ``tiles`` (``((T, B, H), (b0, h0, Bg, Hg))``) places the launch's
    tiles in a larger grid whose draws they take (:func:`draw_tile`);
    by default they are the whole grid.  Returns the output and, per
    stage, the flat indices drawn and their values."""
    g_, n, d = q.shape
    gd = [U64(g) if tiles is None else draw_tile(g, *tiles)
          for g in range(g_)]
    subs = tile_subkeys(key)
    q, k, v = (x.astype(np.int64) for x in (q, k, v))
    drawn = {0: [], 1: []}

    def pairs(counts, flat):
        """A row's lanes cut into passes of two words, the last padded
        with lanes that count zero."""
        pad = (-counts.size) % 64
        counts = np.pad(counts, (0, pad))
        flat = flat[0] + np.arange(counts.size, dtype=U64)
        return [(counts[x:x + 64], flat[x:x + 64])
                for x in range(0, counts.size, 64)]

    rq = plan.rows or n
    nc_max = plan.keys or 32 * -(-n // 32)
    nrb = -(-n // rq)
    # score stage: every block's rows, chunk by chunk
    score_passes, where = [], []
    for blk in range(g_ * nrb):
        g, i0 = blk // nrb, blk % nrb * rq
        rows = min(rq, n - i0)
        jmax = i0 + rows if causal else n
        for j0 in range(0, jmax, nc_max):
            nc = min(nc_max, jmax - j0)
            jj = np.arange(32 * -(-nc // 32))
            j = j0 + jj
            for r in range(rows):
                i = i0 + r
                seen = (jj < nc) & (j < (i + 1 if causal else n))
                cnt = np.where(seen, k[g, np.minimum(j, n - 1)] @ q[g, i], 0)
                flat = (gd[g] * U64(n) + U64(i)) * U64(n) + j.astype(U64)
                for x, pp in enumerate(pairs(cnt, flat)):
                    score_passes.append(pp)
                    where.append((g, i, j0 + 64 * x, j.size - 64 * x))
    s = np.zeros((g_, n, 32 * -(-n // 32) + 64), bool)
    for (g, i, j0, width), counts, r in zip(
            where, (c for c, _ in score_passes),
            warp_draws(score_passes, subs[0], d, drawn[0])):
        w = min(64, width)
        s[g, i, j0:j0 + w] = (counts > r)[:w]
    # output stage: each row's columns, 64 at a time
    lanes_d = 32 * -(-d // 32)
    col = np.arange(lanes_d)
    vpad = np.pad(v, ((0, 0), (0, 0), (0, lanes_d - d)))
    out_passes, rows_of = [], []
    for g in range(g_):
        for i in range(n):
            cnt = np.where(col < d, s[g, i, :n].astype(np.int64) @ vpad[g], 0)
            flat = (gd[g] * U64(n) + U64(i)) * U64(d) + col.astype(U64)
            for x, pp in enumerate(pairs(cnt, flat)):
                out_passes.append(pp)
                rows_of.append((g, i, 64 * x))
    out = np.zeros((g_, n, lanes_d + 64), np.uint8)
    for (g, i, d0), (counts, _), r in zip(
            rows_of, out_passes, warp_draws(out_passes, subs[1], n,
                                            drawn[1])):
        out[g, i, d0:d0 + 64] = counts > r
    return out[:, :, :d], drawn


# (t, b, h, n, d, causal, plan): the ViT's tile, the paper GPT's causal
# N = 37, N != D with neither a multiple of 32, and the streaming design's
# row blocks and key chunks at a small forced plan
TILE_CASES = {
    "vit_like": (1, 2, 2, 64, 64, False, None),
    "gpt_causal": (2, 1, 2, 37, 64, True, None),
    "ragged": (1, 3, 1, 45, 40, False, None),
    "ragged_causal": (1, 1, 3, 45, 40, True, None),
    "stream": (1, 2, 1, 70, 24, False, KS.AttentionPlan("stream", 0, 8, 32)),
    "stream_causal": (2, 1, 1, 77, 40, True,
                      KS.AttentionPlan("stream", 0, 16, 64)),
}


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_keyed_tile_draw_chain_equals_jax(case):
    """Every comparator the keyed K8 draws equals JAX's at its element,
    the tile equals JAX's oracle over JAX's draws, and the zero-count
    words (empty query rows, causal words past the diagonal) are
    skipped."""
    t, b, h, n, d, causal, plan = TILE_CASES[case]
    plan = plan or KS.attention_plan(n, d)
    g = t * b * h
    rng = np.random.default_rng(n + d + causal)
    # the heads view of [T, B, N, H*D] trains, flattened (t, b, h)
    q, k, v = ((rng.random((t, b, n, h * d)) < p).astype(np.uint8)
               .reshape(t, b, n, h, d).transpose(0, 1, 3, 2, 4)
               .reshape(g, n, d) for p in (0.3, 0.5, 0.4))
    q[:, ::5] = 0  # empty query rows: their words draw nothing
    jkey = jax.random.PRNGKey(7 * n + d)
    rs, ra = JKOPS.draw_comparator_prns(jkey, (g, n, n), (g, n, d), d, n)
    got, drawn = keyed_tile(q, k, v, np.asarray(jkey), causal, plan)
    for which, want in ((0, np.asarray(rs)), (1, np.asarray(ra))):
        flat = np.concatenate([f for f, _ in drawn[which]]).astype(np.int64)
        vals = np.concatenate([x for _, x in drawn[which]])
        # a drawn word's lanes past the last row's end draw past the tensor
        inside = flat < want.size
        assert np.array_equal(vals[inside], want.reshape(-1)[flat[inside]])
        # some words drawn, and some skipped
        assert 0 < np.unique(flat[inside]).size < want.size
    ref = JREF.ssa_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), rs, ra, causal=causal)
    assert np.array_equal(got, np.asarray(ref))
    assert 0 < int(got.sum()) < got.size


# (t, bg, hg, b0, h0, b, h, n, d, causal, plan): the LM's shard at (b0, h0)
# = (4, 2) of (B, H) = (8, 4) cut small, a batch shard alone, a head shard
# alone, and the streaming design at an offset
OFFSET_CASES = {
    "lm_shard": (2, 8, 4, 4, 2, 4, 2, 33, 16, True, None),
    "batch": (1, 3, 2, 1, 0, 2, 2, 20, 24, False, None),
    "heads": (2, 1, 6, 0, 3, 1, 3, 17, 16, True, None),
    "stream": (1, 2, 2, 1, 1, 1, 1, 70, 24, True,
               KS.AttentionPlan("stream", 0, 8, 32)),
}


@pytest.mark.parametrize("case", sorted(OFFSET_CASES))
def test_keyed_tile_at_an_offset_equals_jax(case):
    """A launch holding the block ``[b0, b0+b) x [h0, h0+h)`` of a ``[T,
    Bg, Hg]`` grid (a mesh rank's batch rows and heads) draws JAX's
    comparators of the whole grid at its tiles' global indices, and its
    output is that block of JAX's whole tile."""
    t, bg, hg, b0, h0, b, h, n, d, causal, plan = OFFSET_CASES[case]
    plan = plan or KS.attention_plan(n, d)
    rng = np.random.default_rng(n + d + b0 + h0)
    q, k, v = ((rng.random((t, bg, hg, n, d)) < p).astype(np.uint8)
               for p in (0.3, 0.5, 0.4))
    gg = t * bg * hg
    jkey = jax.random.PRNGKey(3 * n + d)
    rs, ra = JKOPS.draw_comparator_prns(jkey, (gg, n, n), (gg, n, d), d, n)
    whole = np.asarray(JREF.ssa_attention_ref(
        *(jnp.asarray(x.reshape(gg, n, d)) for x in (q, k, v)), rs, ra,
        causal=causal)).reshape(t, bg, hg, n, d)
    sl = (slice(None), slice(b0, b0 + b), slice(h0, h0 + h))
    mine = [x[sl].reshape(t * b * h, n, d) for x in (q, k, v)]
    got, drawn = keyed_tile(*mine, np.asarray(jkey), causal, plan,
                            tiles=((t, b, h), (b0, h0, bg, hg)))
    for which, want in ((0, np.asarray(rs)), (1, np.asarray(ra))):
        flat = np.concatenate([f for f, _ in drawn[which]]).astype(np.int64)
        vals = np.concatenate([x for _, x in drawn[which]])
        inside = flat < want.size
        assert np.array_equal(vals[inside], want.reshape(-1)[flat[inside]])
        assert inside.any()
    assert np.array_equal(got.reshape(t, b, h, n, d), whole[sl])
    # the plain version takes the same block of the same grid
    plain = KS.ssa_attention_keyed_kernel(
        *(torch.from_numpy(np.ascontiguousarray(x[sl])) for x in (q, k, v)),
        torch.from_numpy(np.asarray(jkey).astype(np.int64)), causal=causal,
        b0=b0, h0=h0, batch=bg, heads=hg)
    assert np.array_equal(plain.numpy(), whole[sl])
