"""Plain PyTorch versions of the kernels: twins of ``repro.kernels.ref``.

Each function computes the integer, bit-exact semantics of its kernel from
*unpacked* inputs.  They are what a kernel wrapper runs on CPU tensors and
what ``chip_smoke.py`` holds each CUDA kernel against on the card.

Float-rounding discipline (``repro/kernels/ref.py:16-33``): spike counts
are exact integers, taken here in float64 (exact for any integer sum below
2**53, and untouched by TF32); ``counts * scale`` and ``+ bias`` are two
separate float32 roundings (no ``addcmul``/``addmm``); the membrane
``beta * v + pre`` is rounded once per step.  With ``beta`` a power of two
``beta * v`` is exact, so each step commits exactly one rounding, as the
reference's ``lax.scan`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor
Triple = Tuple[Tensor, Tensor, Optional[Tensor]]


def _counts(x: Tensor, w_levels: Tensor) -> Tensor:
    """Exact integer crossbar counts ``[T,B,d_in] x [d_in,d_out]`` as f32."""
    c = torch.matmul(x.to(torch.float64), w_levels.to(torch.float64))
    return c.to(torch.float32)


def lif_ref(currents: Tensor, *, beta: float = 0.5, v_thresh: float = 1.0
            ) -> Tensor:
    """``[T, ...]`` f32 currents -> ``[T, ...]`` uint8 spikes (Eqs. 2-3)."""
    v = torch.zeros_like(currents[0], dtype=torch.float32)
    out = []
    for t in range(currents.shape[0]):
        v = v * beta
        v = v + currents[t].to(torch.float32)
        s = (v >= v_thresh).to(torch.float32)
        out.append(s.to(torch.uint8))
        v = v * (1.0 - s)
    return torch.stack(out)


def aimc_spiking_linear_ref(spikes: Tensor, w_levels: Tensor, scale: Tensor,
                            bias: Optional[Tensor] = None, *,
                            beta: float = 0.5, v_thresh: float = 1.0
                            ) -> Tensor:
    """``[T,B,d_in]`` integer-valued spikes -> ``[T,B,d_out]`` uint8: LIF
    over per-timestep quantised crossbar MVMs."""
    pre = _counts(spikes, w_levels) * scale.to(torch.float32)
    if bias is not None:
        pre = pre + bias.to(torch.float32)
    return lif_ref(pre, beta=beta, v_thresh=v_thresh)


def ssa_decode_ref(q: Tensor, k: Tensor, v: Tensor, rs: Tensor, ra: Tensor
                   ) -> Tensor:
    """One-query SSA decode: ``q [G,1,D]``, ``k``/``v [G,L,D]`` binary,
    ``rs [G,1,L]``, ``ra [G,1,D]`` int32 -> ``[G,1,D]`` uint8.

    Rows beyond a slot's position are zero, so their AND-counts are 0 and
    never beat a non-negative draw: validity masking is implicit."""
    counts_s = torch.matmul(q.to(torch.float64),
                            k.to(torch.float64).transpose(-1, -2))
    s = (counts_s > rs).to(torch.float64)
    counts_a = torch.matmul(s, v.to(torch.float64))
    return (counts_a > ra).to(torch.uint8)


def scatter_at_pos(cache: Tensor, pos: Tensor, rows: Tensor) -> None:
    """In place: ``cache[b, :, pos[b]] = rows[b]`` for every slot whose
    ``pos[b] < L``; writes at or past the end are dropped (the reference's
    out-of-bounds scatter semantics), with no host sync.

    ``cache [B, T, L, ...]``, ``pos [B]``, ``rows [B, T, ...]``."""
    b, l = cache.shape[0], cache.shape[2]
    idx = torch.arange(b, device=cache.device)
    pc = pos.clamp(max=l - 1).to(torch.int64)
    valid = (pos < l).view(b, *([1] * (rows.dim() - 1)))
    cache[idx, :, pc] = torch.where(valid, rows.to(cache.dtype),
                                    cache[idx, :, pc])


def _lin_lif_ref(x: Tensor, w: Triple, *, beta: float, v_thresh: float
                 ) -> Tensor:
    levels, scale, bias = w
    return aimc_spiking_linear_ref(x, levels, scale, bias, beta=beta,
                                   v_thresh=v_thresh).to(torch.float32)


def _ssa_decode_row_ref(q, kf, vf, k_new, v_new, pos, rs, ra):
    """One-query SSA over the *post-scatter* dense cache: q [T,B,H,hd];
    kf/vf [B,T,L,KV,hd] pre-scatter; k_new/v_new [T,B,KV,hd]; rs [B,T,H,L];
    ra [B,T,H,hd] -> a [T,B,H*hd] f32."""
    t, b, h, hd = q.shape
    kv = kf.shape[3]
    kf = kf.clone()
    vf = vf.clone()
    scatter_at_pos(kf, pos, k_new.movedim(0, 1))
    scatter_at_pos(vf, pos, v_new.movedim(0, 1))
    ki = kf.permute(0, 1, 3, 2, 4).to(torch.float64)  # [B,T,KV,L,hd]
    vi = vf.permute(0, 1, 3, 2, 4).to(torch.float64)
    if kv != h:
        ki = ki.repeat_interleave(h // kv, dim=2)
        vi = vi.repeat_interleave(h // kv, dim=2)
    qi = q.movedim(0, 1).to(torch.float64)  # [B,T,H,hd]
    counts_s = torch.matmul(ki, qi.unsqueeze(-1)).squeeze(-1)  # [B,T,H,L]
    s = (counts_s > rs).to(torch.float64)
    counts_a = torch.matmul(s.unsqueeze(-2), vi).squeeze(-2)  # [B,T,H,hd]
    a = (counts_a > ra).to(torch.float32)
    return a.movedim(0, 1).reshape(t, b, h * hd)


def decode_layer_ref(s: Tensor, sk: Tensor, sv: Tensor, pos: Tensor,
                     wq: Triple, wk: Triple, wv: Triple,
                     wo: Optional[Triple], wi: Optional[Triple],
                     wo2: Optional[Triple], rs: Tensor, ra: Tensor, *,
                     hd: int, with_tail: bool = True, with_mlp: bool = True,
                     beta: float = 0.5, v_thresh: float = 1.0):
    """One spiking decoder layer step over a dense cache, op for op the
    unfused decode path: Q/K/V spiking linears, scatter at ``pos``, one
    SSA query row over the whole cache, attention-out, residual, FFN tail.

    ``s [T,B,d]`` integer-valued f32; ``sk``/``sv [B,T,L,KV,hd]`` uint8
    pre-scatter; ``pos [B]``; ``rs [B,T,H,L]``, ``ra [B,T,H,hd]`` int32.
    Returns ``(s_out [T,B,d], k_new [T,B,KV,hd] u8, v_new)``, or the
    attention train ``a [T,B,H*hd]`` first when ``with_tail=False``."""
    t, b, _ = s.shape
    kw = dict(beta=beta, v_thresh=v_thresh)
    q = _lin_lif_ref(s, wq, **kw).reshape(t, b, -1, hd)
    k_new = _lin_lif_ref(s, wk, **kw).reshape(t, b, -1, hd)
    v_new = _lin_lif_ref(s, wv, **kw).reshape(t, b, -1, hd)
    a = _ssa_decode_row_ref(q, sk, sv, k_new, v_new, pos, rs, ra)
    k_new = k_new.to(torch.uint8)
    v_new = v_new.to(torch.uint8)
    if not with_tail:
        return a, k_new, v_new
    s1 = s + _lin_lif_ref(a, wo, **kw)
    if with_mlp:
        h1 = _lin_lif_ref(s1, wi, **kw)
        s1 = s1 + _lin_lif_ref(h1, wo2, **kw)
    return s1, k_new, v_new
