"""RecurrentGemma's RG-LRU block (arXiv:2402.19427): the twin of
``repro/models/rglru.py``.

Per channel::

    r_t = sigmoid(W_r x_t + b_r)            recurrence gate
    i_t = sigmoid(W_i x_t + b_i)            input gate
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block: in-projections to ``x`` and a gate, a short causal depthwise
convolution on ``x``, the RG-LRU, then the out-projection of ``h *
gelu(gate)``.  Train and prefill evaluate the linear recurrence with a
log-depth (Hillis-Steele) scan over the sequence in plain torch; the
reference's ``lax.associative_scan`` combines the same pairs in another
tree, so the two agree to float32 rounding, not bit for bit.  Decode
carries ``h`` (float32) and the convolution's last inputs, updated **in
place** in the per-slot cache ``{h, conv, pos}``.

On a training mesh whose ``model`` axis cuts ``lru``, :func:`rglru_mixer`
runs the rank's channels: ``w_x``, ``w_gate``, the convolution, the
biases and ``Lambda`` on its columns; ``w_r`` and ``w_i`` are cut on their
input rows, so ``xc @ w_r`` is a partial sum of every channel's gate,
reduce-scattered over the group to the rank's channels before the
sigmoid; the scan runs per channel; ``w_out``'s rows are summed over the
group.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import cut_mesh
from repro_torch.models.ssm import conv_step, depthwise_causal_conv

Tensor = torch.Tensor

_C = 8.0


def rglru_width(cfg) -> int:
    return cfg.rglru_width or cfg.d_model


def rglru_schema(cfg) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Leaf shapes and initialisers (``normal``, ``zeros``, ``ones``)."""
    d, w, k = cfg.d_model, rglru_width(cfg), cfg.rglru_conv_width
    return {
        "w_x": ((d, w), "normal"),
        "w_gate": ((d, w), "normal"),
        "conv_w": ((k, w), "normal"),
        "conv_b": ((w,), "zeros"),
        "w_r": ((w, w), "normal"),
        "b_r": ((w,), "zeros"),
        "w_i": ((w, w), "normal"),
        "b_i": ((w,), "zeros"),
        "lam": ((w,), "ones"),
        "w_out": ((w, d), "normal"),
    }


def _gates(params, xc: Tensor, mesh=None) -> Tuple[Tensor, Tensor, Tensor]:
    """``(a, sqrt(1 - a^2), i)``; ``mesh``: ``xc`` is the rank's channels
    and ``w_r``/``w_i`` its input rows (see the module)."""
    def pre(w):
        y = xc @ params[w].to(xc.dtype)
        return y if mesh is None else mesh.reduce_scatter_model(y, -1)

    r = torch.sigmoid(pre("w_r") + params["b_r"].to(xc.dtype))
    i = torch.sigmoid(pre("w_i") + params["b_i"].to(xc.dtype))
    log_a = (-_C * F.softplus(params["lam"].to(torch.float32))
             * r.to(torch.float32))
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta, i


def linear_scan(a: Tensor, b: Tensor, dim: int = 1) -> Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` from ``h_{-1} = 0`` along ``dim``, in
    ``ceil(log2(L))`` whole-tensor steps: after the step of offset ``o``
    every position holds the composition of its last ``2 o`` elements."""
    n = a.shape[dim]
    off = 1
    while off < n:
        a_lo, b_lo = a.narrow(dim, 0, n - off), b.narrow(dim, 0, n - off)
        a_hi, b_hi = a.narrow(dim, off, n - off), b.narrow(dim, off, n - off)
        a = torch.cat([a.narrow(dim, 0, off), a_hi * a_lo], dim=dim)
        b = torch.cat([b.narrow(dim, 0, off), a_hi * b_lo + b_hi], dim=dim)
        off *= 2
    return b


def rglru_mixer(params, x: Tensor, cfg, pctx=None) -> Tensor:
    """``x [B,L,D] -> [B,L,D]`` (train/prefill); on a training mesh's
    cut, the rank's channels (see the module)."""
    mesh = cut_mesh(pctx, params["lam"], -1, rglru_width(cfg))
    xm = x if mesh is None else mesh.copy_to_model(x)
    xin = xm @ params["w_x"].to(x.dtype)
    gate = xm @ params["w_gate"].to(x.dtype)
    xc = depthwise_causal_conv(xin, params["conv_w"], params["conv_b"])
    a, beta, i = _gates(params, xc, mesh)
    h = linear_scan(a, beta * (i * xc).to(torch.float32))
    y = h.to(x.dtype) * F.gelu(gate, approximate="tanh")
    out = y @ params["w_out"].to(x.dtype)
    return out if mesh is None else mesh.reduce_from_model(out)


def rglru_cache(cfg, batch: int, device, lead: Tuple[int, ...] = ()
                ) -> Dict[str, Tensor]:
    """A zero decode cache (``rglru_cache_schema``): ``h [B,W]`` float32,
    the convolution's last ``K-1`` inputs and ``pos``."""
    w, k = rglru_width(cfg), cfg.rglru_conv_width
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return {"h": torch.zeros(lead + (batch, w), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, k - 1, w), dtype=dt,
                                device=device),
            "pos": torch.zeros(lead + (batch,), dtype=torch.int32,
                               device=device)}


def rglru_decode(params, x: Tensor, cache: Dict[str, Tensor], cfg
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode, ``x [B,1,D]``; the cache is updated in place and
    returned."""
    xin = x @ params["w_x"].to(x.dtype)  # [B,1,W]
    gate = x @ params["w_gate"].to(x.dtype)
    hist = torch.cat([cache["conv"].to(x.dtype), xin], dim=1)
    xc = conv_step(hist, params["conv_w"], params["conv_b"])[:, None, :]
    a, beta, i = _gates(params, xc)
    h = a[:, 0] * cache["h"] + beta[:, 0] * (i[:, 0] * xc[:, 0]).to(torch.float32)
    y = h[:, None, :].to(x.dtype) * F.gelu(gate, approximate="tanh")
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:, :])
    cache["pos"] += 1
    return y @ params["w_out"].to(x.dtype), cache
