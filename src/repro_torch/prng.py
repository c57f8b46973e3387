"""A torch twin of ``jax.random`` as the reference package draws it.

Every spike the system emits is a comparison against a threefry2x32 draw,
and the contract is bit-equality with the JAX streams, so these functions
reproduce JAX's algorithms exactly (``jax/_src/prng.py`` and
``jax/_src/random.py``, in the *partitionable* threefry mode that the
reference runs with: ``jax.config.jax_threefry_partitionable``):

* a key is a pair of uint32 words, held here in the last axis of an int64
  tensor (torch's ``uint32`` lacks arithmetic on CUDA) with values in
  ``[0, 2**32)``;
* ``fold_in(key, d) = threefry(key, (0, d))``; ``split(key, n)[i] =
  threefry(key, (0, i))``; ``random_bits(key, shape)[i] = y0 ^ y1`` of
  ``threefry(key, (i >> 32, i & 0xffffffff))`` over the flat index ``i``;
* ``randint`` uses JAX's two-word method (a split key, higher and lower
  words, a ``2**16 % span`` multiplier) for every span, power of two or not;
* ``uniform`` keeps the top 23 bits as the mantissa of a float in [1, 2)
  and subtracts one, which is ``(bits >> 9) * 2**-23`` exactly.

Every function is vectorised over the key's leading axes: where the
reference ``vmap``s a draw over slots and heads, the port passes a
``[B, H, 2]`` key tensor and gets ``[B, H, *shape]`` back.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

Tensor = torch.Tensor

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: Tensor, k1: Tensor, x0: Tensor, x1: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """The Threefry-2x32 block cipher (20 rounds), elementwise over
    broadcastable int64 tensors holding uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, device: Union[str, torch.device] = "cpu") -> Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def key_from_seeds(seeds: Tensor) -> Tensor:
    """Stack ``[0, seed]`` keys for a tensor of 32-bit seeds: ``[..., 2]``."""
    s = seeds.to(torch.int64) & _M32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: Tensor, data: Union[int, Tensor]) -> Tensor:
    """``jax.random.fold_in``; ``data`` broadcasts against the key's
    leading axes (an int, or a tensor of them)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(key: Tensor, num: int = 2) -> Tensor:
    """``jax.random.split``: ``[..., 2] -> [..., num, 2]``."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: Tensor, shape: Tuple[int, ...]) -> Tensor:
    """32-bit random words ``[..., *shape]`` (int64 holding uint32)."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(*lead, 1)
    k1 = key[..., 1].reshape(*lead, 1)
    y0, y1 = threefry2x32(k0, k1, i >> 32, i & _M32)
    return (y0 ^ y1).reshape(*lead, *shape)


def randint(key: Tensor, shape: Tuple[int, ...], minval: int, maxval: int
            ) -> Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``."""
    k = split(key)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    multiplier = (2 ** 16 % span) ** 2 % span
    offset = (((higher % span) * multiplier) & _M32) + lower % span
    offset = (offset & _M32) % span
    return (offset + minval).to(torch.int32)


def uniform(key: Tensor, shape: Tuple[int, ...]) -> Tensor:
    """``jax.random.uniform(key, shape)`` in float32, on [0, 1)."""
    bits = random_bits(key, shape)
    return (bits >> 9).to(torch.float32) * (2.0 ** -23)
