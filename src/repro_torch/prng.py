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
  words, a ``2**16 % span`` multiplier squared in uint32) for every span,
  power of two or not;
* ``uniform`` keeps the top 23 bits as the mantissa of a float in [1, 2)
  and subtracts one, which is ``(bits >> 9) * 2**-23`` exactly, then maps
  [0, 1) onto ``[minval, maxval)`` as JAX does;
* ``normal`` is ``sqrt(2) * erfinv`` of a uniform on ``(-1, 1)``: exact up
  to the ``erfinv``, which is a float boundary (torch's and XLA's differ
  in the last bits).

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
    broadcastable int64 tensors holding uint32 values.  The first mix runs
    out of place, which gives both words the full broadcast shape as fresh
    tensors; every later op updates them in place (the same ops, without
    an allocation each)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    hi = None
    for i in range(5):
        for r in _ROT[i % 2]:
            if hi is None:
                x0 = (x0 + x1) & _M32
                x1 = _rotl(x1, r) ^ x0
                hi = torch.empty_like(x1)
                continue
            x0.add_(x1).bitwise_and_(_M32)
            torch.bitwise_left_shift(x1, r, out=hi)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(hi).bitwise_and_(
                _M32).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_M32)
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
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    return random_bits_at(key, i).reshape(*key.shape[:-1], *shape)


def random_bits_at(key: Tensor, index: Tensor) -> Tensor:
    """The words of :func:`random_bits` at flat indices ``index`` (int64,
    any shape) of a larger draw: in the partitionable mode a word depends
    on its flat index alone, so a shard of a draw is drawn where it lies.
    Vectorised over the key's leading axes: ``[..., *index.shape]``."""
    lead = key.shape[:-1]
    pad = (1,) * index.dim()
    k0 = key[..., 0].reshape(*lead, *pad)
    k1 = key[..., 1].reshape(*lead, *pad)
    y0, y1 = threefry2x32(k0, k1, index >> 32, index & _M32)
    return y0 ^ y1


def randint_multiplier(span: int) -> int:
    """``randint``'s ``(2**16 % span)**2 % span``, the square wrapping at
    32 bits as JAX's uint32 product does (0 for any span past 2**16)."""
    m = 2 ** 16 % span
    return (m * m & _M32) % span


def randint(key: Tensor, shape: Tuple[int, ...], minval: int, maxval: int
            ) -> Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``."""
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    return randint_at(key, i, minval, maxval).reshape(*key.shape[:-1],
                                                       *shape)


def randint_at(key: Tensor, index: Tensor, minval: int, maxval: int
               ) -> Tensor:
    """The integers of :func:`randint` at flat indices ``index`` of a
    larger draw (see :func:`random_bits_at`)."""
    k = split(key)
    higher = random_bits_at(k[..., 0, :], index)
    lower = random_bits_at(k[..., 1, :], index)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    multiplier = randint_multiplier(span)
    offset = (((higher % span) * multiplier) & _M32) + lower % span
    offset = (offset & _M32) % span
    return (offset + minval).to(torch.int32)


def uniform(key: Tensor, shape: Tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> Tensor:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``:
    ``max(minval, u * (maxval - minval) + minval)`` over the [0, 1) draw.
    XLA contracts ``u * span + minval`` into one fused multiply-add; the
    product of two float32 values is exact in float64, so the sum is
    taken there and rounded to float32 once (for the default range the
    draw is returned as it is)."""
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    return uniform_at(key, i, minval, maxval).reshape(*key.shape[:-1], *shape)


def uniform_at(key: Tensor, index: Tensor, minval: float = 0.0,
               maxval: float = 1.0) -> Tensor:
    """The values of :func:`uniform` at flat indices ``index`` of a larger
    draw (see :func:`random_bits_at`)."""
    bits = random_bits_at(key, index)
    u = (bits >> 9).to(torch.float32) * (2.0 ** -23)
    if minval == 0.0 and maxval == 1.0:
        return u
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=key.device) - lo
    out = (u.double() * span.double() + lo.double()).to(torch.float32)
    return torch.maximum(lo, out)


def uniform_rows(key: Tensor, shape: Tuple[int, ...], b0: int = 0) -> Tensor:
    """Rows ``b0 .. b0+shape[0]`` of :func:`uniform`'s ``[0, 1)`` draw
    over a larger leading axis (the other axes ``shape[1:]``), drawn where
    they lie (:func:`random_bits_at`): a data rank's share of a batch's
    draw.  ``b0 = 0`` is :func:`uniform` itself."""
    per = math.prod(shape[1:])
    i = torch.arange(b0 * per, (b0 + shape[0]) * per, dtype=torch.int64,
                     device=key.device)
    bits = random_bits_at(key, i).reshape(*key.shape[:-1], *shape)
    return (bits >> 9).to(torch.float32) * (2.0 ** -23)


def uniform_block(key: Tensor, shape: Tuple[int, ...],
                  starts: Tuple[int, ...], whole: Tuple[int, ...]) -> Tensor:
    """The block ``shape`` at ``starts`` of :func:`uniform`'s ``[0, 1)``
    draw of shape ``whole`` (the leading axis of ``whole`` is not read),
    drawn where it lies (:func:`random_bits_at`): a mesh rank's rows and
    heads of a batch's draw."""
    dev = key.device
    idx = torch.zeros((1,) * len(shape), dtype=torch.int64, device=dev)
    stride = 1
    for ax in range(len(shape) - 1, -1, -1):
        view = [1] * len(shape)
        view[ax] = shape[ax]
        pos = torch.arange(starts[ax], starts[ax] + shape[ax],
                           dtype=torch.int64, device=dev)
        idx = idx + pos.view(view) * stride
        stride *= whole[ax] if ax else 1
    bits = random_bits_at(key, idx.reshape(-1)).reshape(*key.shape[:-1],
                                                         *shape)
    return (bits >> 9).to(torch.float32) * (2.0 ** -23)


# the open interval's lower end of ``jax._src.random._normal_real``:
# nextafter(-1, 0) in float32
_NORMAL_LO = -(1.0 - 2.0 ** -24)


def normal(key: Tensor, shape: Tuple[int, ...]) -> Tensor:
    """``jax.random.normal(key, shape, jnp.float32)``: a uniform on
    ``[nextafter(-1, 0), 1)`` through ``sqrt(2) * erf_inv(u)``
    (``jax._src.random._normal_real``).  The uniform is JAX's bit for bit;
    ``torch.erfinv`` and XLA's ``erf_inv`` are different approximations,
    so the normals agree with JAX's to a few float32 ulps, not exactly."""
    return normal_erfinv(key, shape) * math.sqrt(2.0)


def normal_at(key: Tensor, index: Tensor) -> Tensor:
    """The values of :func:`normal` at flat indices ``index`` of a larger
    draw (see :func:`random_bits_at`): a draw too large to hold its index
    words at once is made a piece at a time."""
    return torch.erfinv(uniform_at(key, index, _NORMAL_LO, 1.0)) * math.sqrt(2.0)


def normal_erfinv(key: Tensor, shape: Tuple[int, ...]) -> Tensor:
    """``erf_inv(u)`` of :func:`normal`'s uniform, before the ``sqrt(2)``
    (for callers that fold that factor as XLA does)."""
    return torch.erfinv(uniform(key, shape, _NORMAL_LO, 1.0))


# the smallest normal float32, gumbel's lower bound (``finfo.tiny``)
_TINY = float(torch.finfo(torch.float32).tiny)


def gumbel(key: Tensor, shape: Tuple[int, ...]) -> Tensor:
    """``jax.random.gumbel(key, shape, jnp.float32)`` in its default
    ``"low"`` mode: ``-log(-log(u))`` of a uniform on ``[tiny, 1)``.  The
    uniform is JAX's bit for bit; the two logs are float boundaries, so
    the values agree with JAX's to a few float32 ulps."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: Tensor, logits: Tensor, axis: int = -1) -> Tensor:
    """``jax.random.categorical(key, logits, axis)``: the Gumbel-max
    sample, ``argmax(gumbel(key, logits.shape) + logits, axis)`` (the
    first index of a tie, as ``jnp.argmax``)."""
    lead = key.shape[:-1]
    g = gumbel(key, tuple(logits.shape[len(lead):]))
    return torch.argmax(g + logits, dim=axis)
