"""The keyed K2's in-kernel draw chain against ``jax.random``, on the CPU.

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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JKOPS
from repro_torch import prng

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


