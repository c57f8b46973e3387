"""Bernoulli rate coding (Eq. 1), forward only (``repro.core.spikes``).

``rate_encode`` draws its uniforms from the threefry twin, so with the same
key it emits the reference's spikes wherever the probabilities agree
bitwise; the forward of ``bernoulli_st`` is ``u < p``.
"""

from __future__ import annotations

import torch

from repro_torch import prng

Tensor = torch.Tensor


def rate_encode(key: Tensor, x: Tensor, T: int) -> Tensor:
    """Probabilities ``x`` in [0, 1] -> spike trains ``(T,) + x.shape``.

    Vectorised over the key's leading axes: with ``key [B, 2]`` and ``x
    [B, *s]`` each slot draws from its own key and the result is ``[B, T,
    *s]`` (the caller moves the T axis where it needs it)."""
    x = torch.clamp(x, 0.0, 1.0)
    lead = key.shape[:-1]
    u = prng.uniform(key, (T,) + tuple(x.shape[len(lead):]))
    return (u < x.unsqueeze(len(lead))).to(x.dtype)


def rate_decode(spikes: Tensor) -> Tensor:
    """Decode a spike train by its firing rate (mean over the T axis 0)."""
    return torch.mean(spikes, dim=0)
