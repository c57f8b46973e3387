"""The float attentions: differentiable SSA and the baseline rows.

Twins of ``repro/core/ssa.py:40`` (``_causal_mask``), ``:44-90``
(``ssa_attention``, the differentiable SSA of the reference backend, which
training runs) and ``:147-196`` (``lif_spiking_attention``, the
Spikformer-style LIF attention of the ``"lif"`` rows, and
``ann_attention``, the softmax attention of the ``"ann"`` rows).  None is
a TPU kernel: plain tensor ops written as the reference writes them.  SSA
on the digital backends is the backend's ``ssa_attention`` (K8).

The float SSA draws its uniforms from the threefry twin with the
reference's keys (``split(key, 2T)``, two a timestep), so its spikes equal
the reference's wherever its probabilities do.  Its counts are exact
integers; ``/ d`` and ``/ N`` are XLA's products with the reciprocal (the
reference's training step is jitted), and the output probability's clip
is :func:`repro_torch.core.spikes.clip01` (gradient 0.5 at a tie, which a
zero count is).  The sampler is straight-through.

The LIF attention's spikes equal the reference's exactly.  Its membranes
are updated in the reference's order, and its ``/ d`` and ``/ N`` are
taken as XLA takes a division by a constant under ``jit``: a product with
the float32 reciprocal (:func:`mul_reciprocal`).  At ``N = 37`` that
product differs from a true division, and a membrane that lands on the
threshold fires by it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core import spikes as SP
from repro_torch.core.aimc import mul_reciprocal

Tensor = torch.Tensor


def _causal_mask(n: int, dtype=torch.float32, device=None) -> Tensor:
    return torch.tril(torch.ones((n, n), dtype=dtype, device=device))


def ssa_attention(key: Tensor, q: Tensor, k: Tensor, v: Tensor, *,
                  causal: bool = False, b0: int = 0, h0: int = 0,
                  heads: Optional[int] = None) -> Tensor:
    """Differentiable SSA over float spike trains ``[T, B, H, N, d]``:
    per timestep ``S ~ Bern(Q K^T / d)`` (causal: masked), ``A ~ Bern(clip(S
    V / N))``, both straight-through, ``S`` drawn from ``split(key,
    2T)[2t]`` and ``A`` from ``[2t + 1]`` (every timestep at once: the
    twin is vectorised over keys).  ``b0``: these are rows ``b0 ..
    b0+B`` of a larger batch, and draw that batch's comparators for those
    rows (a data rank's share); ``h0``, ``heads``: these are heads ``h0 ..
    h0+H`` of ``heads`` (a model rank's share), drawn where they lie in
    the whole draw.  Returns spikes of ``q``'s dtype."""
    t, b, h, n, d = q.shape
    heads = h if heads is None else heads
    keys = prng.split(key, 2 * t).reshape(t, 2, 2)

    def draws(k2, last):
        shape = (b, h, n, last)
        if h0 == 0 and heads == h:
            return prng.uniform_rows(k2, shape, b0)
        return prng.uniform_block(k2, shape, (b0, h0, 0, 0),
                                  (None, heads, n, last))

    counts_s = torch.einsum("tbhnd,tbhmd->tbhnm", q, k)
    p_s = mul_reciprocal(counts_s, d)
    if causal:
        p_s = p_s * _causal_mask(n, q.dtype, q.device)
    s = SP.bernoulli_st(p_s, draws(keys[:, 0], n))
    counts_a = torch.einsum("tbhnm,tbhmd->tbhnd", s, v)
    # the output comparator's range is N in causal mode too (Sec. IV-B-2)
    p_a = SP.clip01(mul_reciprocal(counts_a, n))
    return SP.bernoulli_st(p_a, draws(keys[:, 1], d))


def lif_spiking_attention(q: Tensor, k: Tensor, v: Tensor, *,
                          v_thresh_s: float = 0.5, v_thresh_a: float = 0.5,
                          causal: bool = False) -> Tensor:
    """Spikformer-style attention ``LIF(LIF(Q^t K^t^T) V^t)`` over float
    spike trains ``[T, B, H, N, d]``: the score and output membranes leak
    by half a step, integrate the scaled integer products, fire at their
    thresholds and reset to zero.  Returns spikes of ``q``'s dtype."""
    t, b, h, n, d = q.shape
    mask = _causal_mask(n, q.dtype, q.device) if causal else None
    v_s = torch.zeros((b, h, n, n), dtype=q.dtype, device=q.device)
    v_a = torch.zeros((b, h, n, d), dtype=q.dtype, device=q.device)
    out = []
    for qt, kt, vt in zip(q, k, v):
        scores = mul_reciprocal(torch.einsum("bhnd,bhmd->bhnm", qt, kt), d)
        if mask is not None:
            scores = scores * mask
        v_s = 0.5 * v_s + scores
        s_t = (v_s >= v_thresh_s).to(q.dtype)
        v_s = v_s * (1.0 - s_t)
        o = mul_reciprocal(torch.einsum("bhnm,bhmd->bhnd", s_t, vt), n)
        v_a = 0.5 * v_a + o
        a_t = (v_a >= v_thresh_a).to(q.dtype)
        v_a = v_a * (1.0 - a_t)
        out.append(a_t)
    return torch.stack(out)


def ann_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False
                  ) -> Tensor:
    """Softmax attention over ``[B, H, N, d]`` (the ANN rows)."""
    d = q.shape[-1]
    scale = torch.sqrt(torch.tensor(d, dtype=q.dtype, device=q.device))
    scores = torch.einsum("bhnd,bhmd->bhnm", q, k) / scale
    if causal:
        n = q.shape[-2]
        neg = torch.finfo(q.dtype).min
        scores = torch.where(_causal_mask(n, torch.bool, q.device), scores,
                             torch.tensor(neg, dtype=q.dtype, device=q.device))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", w, v)
