"""The baseline attentions of the paper's comparison rows.

Twins of ``repro/core/ssa.py:40`` (``_causal_mask``) and ``:147-196``
(``lif_spiking_attention``, the Spikformer-style LIF attention of the
``"lif"`` rows, and ``ann_attention``, the softmax attention of the
``"ann"`` rows).  Neither is a TPU kernel: plain tensor ops written as
the reference writes them.  SSA itself (the ``"ssa"`` rows) is the
backend's ``ssa_attention`` (K8).

The LIF attention's spikes equal the reference's exactly.  Its membranes
are updated in the reference's order, and its ``/ d`` and ``/ N`` are
taken as XLA takes a division by a constant under ``jit``: a product with
the float32 reciprocal (:func:`mul_reciprocal`).  At ``N = 37`` that
product differs from a true division, and a membrane that lands on the
threshold fires by it.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _causal_mask(n: int, dtype=torch.float32, device=None) -> Tensor:
    return torch.tril(torch.ones((n, n), dtype=dtype, device=device))


def mul_reciprocal(x: Tensor, c: float) -> Tensor:
    """``x / c`` as XLA computes a division by a constant under ``jit``:
    ``x * (1 / c)`` with the reciprocal rounded to float32 first (a
    float32 division of CPU tensors, then a product with a float32-exact
    scalar: no copy to the card)."""
    r = torch.ones((), dtype=torch.float32) / torch.tensor(float(c))
    return x * r.item()


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
