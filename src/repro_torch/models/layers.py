"""Float layers around the spiking stack: embedding, norms, unembedding.

Twins of ``repro/models/layers.py:69-86,400-412``.  These are float
boundaries: the port's values agree with XLA's to float32 rounding, not
bit for bit (the logits, not the spikes, come out of them).  The unembed
is a plain ``torch.matmul``; ``repro_torch.serving`` turns TF32 off for
float32 matmuls on the card.
"""

from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor


def rmsnorm(params: Dict[str, Tensor], x: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def layernorm(params: Dict[str, Tensor], x: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def apply_norm(kind: str, params, x: Tensor) -> Tensor:
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


def embed(params, tokens: Tensor, dtype) -> Tensor:
    return params["table"].to(dtype)[tokens]


def unembed(params, x: Tensor, cfg) -> Tensor:
    logits = torch.matmul(x, params["w"].to(x.dtype))
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits
