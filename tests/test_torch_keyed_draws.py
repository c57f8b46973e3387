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
from repro_torch import prng
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
