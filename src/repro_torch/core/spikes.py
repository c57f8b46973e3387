"""Spike encoding, the float LIF neuron and the surrogate gradients
(``repro.core.spikes``, lines 41-151).

* :class:`HeavisideST` / :func:`heaviside_st` -- the spike function with
  the fast-sigmoid surrogate: forward ``v >= 0``, backward ``g / (1 +
  alpha |v|)**2`` (lines 41-63);
* :class:`BernoulliST` / :func:`bernoulli_st` -- the straight-through
  Bernoulli sampler: forward ``u < p``, backward passes ``g`` to ``p``
  only (lines 66-86);
* :func:`rate_encode` -- Bernoulli rate coding (Eq. 1) with its uniforms
  from the threefry twin, so with the same key it emits the reference's
  spikes wherever the probabilities agree bitwise; straight-through, so the
  broadcast of ``x`` over ``T`` sums its gradient; :func:`rate_encode_rows`
  draws a mesh rank's rows of a batch's coding;
* :func:`lif_step` / :func:`lif` -- the float LIF neuron of the reference
  backend (lines 130-151): ``v = beta v + i``, spike ``H(v - v_th)``,
  reset ``v (1 - s)``, the gradient flowing through the reset too.

Both surrogates compute their backward in the reference's op order, so
their gradients equal ``jax.grad`` of the custom VJPs bit for bit.  The
clip of rate coding is ``min(max(x, 0), 1)``: at a tie its gradient is
0.5, as ``jnp.clip``'s (``torch.clamp`` passes 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch import prng

Tensor = torch.Tensor


class HeavisideST(torch.autograd.Function):
    """Heaviside step with the fast-sigmoid surrogate gradient."""

    @staticmethod
    def forward(ctx, v: Tensor, alpha: float) -> Tensor:
        ctx.save_for_backward(v)
        ctx.alpha = alpha
        return (v >= 0.0).to(v.dtype)

    @staticmethod
    def backward(ctx, g: Tensor):
        (v,) = ctx.saved_tensors
        surr = 1.0 / (1.0 + ctx.alpha * torch.abs(v)) ** 2
        return g * surr, None


class BernoulliST(torch.autograd.Function):
    """Straight-through Bernoulli: forward ``u < p``, backward identity to
    ``p`` (``u`` is a constant)."""

    @staticmethod
    def forward(ctx, p: Tensor, u: Tensor) -> Tensor:
        return (u < p).to(p.dtype)

    @staticmethod
    def backward(ctx, g: Tensor):
        return g, None


def heaviside_st(v: Tensor, alpha: float = 2.0) -> Tensor:
    return HeavisideST.apply(v, alpha)


def bernoulli_st(p: Tensor, u: Tensor) -> Tensor:
    return BernoulliST.apply(p, u)


def clip01(x: Tensor) -> Tensor:
    """``jnp.clip(x, 0, 1)`` with its gradient: ``min(max(x, 0), 1)``
    splits the gradient at a tie (0.5), as JAX's ``max``/``min`` do."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, zero), zero + 1.0)


def rate_encode(key: Tensor, x: Tensor, T: int) -> Tensor:
    """Probabilities ``x`` in [0, 1] -> spike trains ``(T,) + x.shape``
    (straight-through: the gradient of every step flows back to ``x``).

    Vectorised over the key's leading axes: with ``key [B, 2]`` and ``x
    [B, *s]`` each slot draws from its own key and the result is ``[B, T,
    *s]`` (the caller moves the T axis where it needs it)."""
    x = clip01(x)
    lead = key.shape[:-1]
    u = prng.uniform(key, (T,) + tuple(x.shape[len(lead):]))
    return bernoulli_st(x.unsqueeze(len(lead)).expand(u.shape), u)


def rate_encode_rows(key: Tensor, x: Tensor, T: int, b0: int, batch: int
                     ) -> Tensor:
    """``rate_encode(key, whole, T)[:, b0:b0+n]`` for ``x = whole[b0:b0+n]``,
    the rows of a batch of ``batch`` on ``x``'s first axis (one key): only
    those rows' uniforms are drawn, where they lie in the whole draw."""
    x = clip01(x)
    n, rest = x.shape[0], tuple(x.shape[1:])
    per = math.prod(rest)
    dev = key.device
    t = torch.arange(T, dtype=torch.int64, device=dev)[:, None, None]
    b = torch.arange(b0, b0 + n, dtype=torch.int64, device=dev)[None, :, None]
    j = torch.arange(per, dtype=torch.int64, device=dev)[None, None, :]
    u = prng.uniform_at(key, (t * batch + b) * per + j).reshape((T, n) + rest)
    return bernoulli_st(x.unsqueeze(0).expand(u.shape), u)


def rate_decode(spikes: Tensor) -> Tensor:
    """Decode a spike train by its firing rate (mean over the T axis 0)."""
    return torch.mean(spikes, dim=0)


@dataclasses.dataclass(frozen=True)
class LIFParams:
    """A copy of ``repro.core.spikes.LIFParams``: beta = 0.5 is the
    hardware's one-bit shift leak."""

    beta: float = 0.5
    v_thresh: float = 1.0
    surrogate_alpha: float = 2.0


def lif_step(v: Tensor, i_t: Tensor, p: LIFParams) -> Tuple[Tensor, Tensor]:
    """One LIF update -> (new membrane, output spikes)."""
    v = p.beta * v + i_t
    s = heaviside_st(v - p.v_thresh, p.surrogate_alpha)
    v = v * (1.0 - s)  # reset to zero on fire
    return v, s


def lif(currents: Tensor, p: LIFParams = LIFParams(),
        v0: Optional[Tensor] = None) -> Tensor:
    """The float LIF over a ``[T, ...]`` current sequence -> ``[T, ...]``
    spikes of the currents' dtype."""
    v = torch.zeros_like(currents[0]) if v0 is None else v0
    out = []
    for i_t in currents:
        v, s = lif_step(v, i_t, p)
        out.append(s)
    return torch.stack(out)


def heads(x: Tensor, h: int) -> Tensor:
    """``[..., N, d]`` -> ``[..., H, N, d/H]``: a view, the heads read in
    place."""
    *lead, n, d = x.shape
    return x.reshape(*lead, n, h, d // h).movedim(-2, -3)


def unheads(x: Tensor) -> Tensor:
    """``[..., H, N, hd]`` -> ``[..., N, H*hd]``."""
    *lead, h, n, hd = x.shape
    return x.movedim(-3, -2).reshape(*lead, n, h * hd)
