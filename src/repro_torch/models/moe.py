"""Mixture-of-Experts on one device: a twin of ``repro/models/moe.py``.

* :func:`router` -- the float32 softmax over the experts, its top-k
  (ties to the lower expert, as ``lax.top_k`` breaks them), the weights
  renormalised and cast back to the input dtype, and the Switch
  load-balancing loss ``E * sum(mean(probs) * mean(choices per expert))``;
* :func:`moe_dense` -- every expert on every token, combined through the
  one-hot of the choices (the reference's smoke-test path);
* :func:`moe_ep` -- the reference's sort-based dispatch (``_ep_local``)
  with no mesh: one model column and one ``d_ff`` shard, so no
  collective.  The ``(token, choice)`` pairs pack into a buffer of
  ``cap = round_up(int(T * k * capacity_factor) + 1, 8)`` rows, then
  group by expert into ``C2`` rows an expert; a choice past either
  capacity is dropped (its slot takes ``+0``), so this is not
  :func:`moe_dense` unless the capacities hold every choice.

The expert products are plain ``einsum`` (the reference's are plain
``jnp`` outside any Pallas kernel); ``index_add`` and ``scatter_reduce
("amin")`` take the place of ``.at[].add`` and ``.at[].min``.  Gradients
flow through autograd.  The expert-parallel all-to-all over a mesh is
ROADMAP A13(b).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _act

Tensor = torch.Tensor


def moe_schema(cfg) -> Dict[str, Any]:
    """``router [d, E]``, ``wi``/``wg [E, d, f]``, ``wo [E, f, d]`` as
    ``(shape, init)`` (``wg`` with a gated MLP)."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    s = {"router": ((d, e), "normal"), "wi": ((e, d, f), "normal"),
         "wo": ((e, f, d), "normal")}
    if cfg.gated_mlp:
        s["wg"] = ((e, d, f), "normal")
    return s


def router(params, x: Tensor, cfg) -> Tuple[Tensor, Tensor, Tensor]:
    """Top-k routing of ``x [..., d]`` -> ``(weights [..., k] in x's
    dtype, idx [..., k] int64, aux)``."""
    logits = (x @ params["router"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps equal probabilities in expert order
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k, e = cfg.moe_top_k, cfg.num_experts
    weights, idx = top[..., :k], idx[..., :k]
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    me = torch.mean(probs.reshape(-1, e), dim=0)
    ce = torch.mean(F.one_hot(idx.reshape(-1, k), e).to(torch.float32)
                    .sum(dim=1), dim=0)
    aux = e * torch.sum(me * ce)
    return weights.to(x.dtype), idx, aux


def _experts(params, xg: Tensor, cfg) -> Tensor:
    """Each expert's (gated) MLP over its rows ``xg [E, C, d]``."""
    dt = xg.dtype
    h = torch.einsum("ecd,edf->ecf", xg, params["wi"].to(dt))
    if "wg" in params:
        h = _act(cfg.act, torch.einsum("ecd,edf->ecf", xg,
                                       params["wg"].to(dt))) * h
    else:
        h = _act(cfg.act, h)
    return torch.einsum("ecf,efd->ecd", h, params["wo"].to(dt))


def moe_dense(params, x: Tensor, cfg) -> Tuple[Tensor, Tensor]:
    """Every expert on every token of ``x [B, S, d]``, combined with the
    router's top-k weights -> ``(y [B, S, d], aux)``."""
    weights, idx, aux = router(params, x, cfg)
    dt = x.dtype
    h = torch.einsum("bsd,edf->bsef", x, params["wi"].to(dt))
    if "wg" in params:
        h = _act(cfg.act, torch.einsum("bsd,edf->bsef", x,
                                       params["wg"].to(dt))) * h
    else:
        h = _act(cfg.act, h)
    y_all = torch.einsum("bsef,efd->bsed", h, params["wo"].to(dt))
    sel = F.one_hot(idx, cfg.num_experts).to(dt)  # [B, S, k, E]
    comb = torch.einsum("bske,bsk->bse", sel, weights)
    return torch.einsum("bsed,bse->bsd", y_all, comb), aux


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacities(n_tok: int, cfg) -> Tuple[int, int]:
    """The dispatch's two capacities for ``n_tok`` tokens on one device:
    ``cap`` rows of packed ``(token, choice)`` pairs, and ``c2`` rows an
    expert (the reference's, with its Python ``int`` of a float)."""
    e = cfg.num_experts
    cap = _round_up(int(max(n_tok, 1) * cfg.moe_top_k * cfg.capacity_factor)
                    + 1, 8)
    return cap, _round_up(min(cap, max(int(cap // max(e, 1) * 1.25), 8)), 8)


def _ep_local(x: Tensor, weights: Tensor, idx: Tensor, params, cfg
              ) -> Tensor:
    """The reference's ``_ep_local`` on one device (``tp_size = fsdp_size
    = 1``): ``x [T, d]``, ``weights``/``idx [T, k]`` -> ``y [T, d]``."""
    n_tok, d = x.shape
    k, e = cfg.moe_top_k, cfg.num_experts
    dev = x.device
    cap, c2 = capacities(n_tok, cfg)
    pn = n_tok * k
    # 1. the (token, choice) pairs in order (one destination column, so
    # the reference's stable sort by column keeps them so), packed into
    # ``cap`` rows; a pair past it is dropped onto the last slot as +0
    flat_idx = idx.reshape(pn)
    flat_w = weights.reshape(pn)
    tok_of = torch.arange(pn, device=dev) // k
    rank = torch.arange(pn, device=dev)
    keep = rank < cap
    slot = torch.where(keep, rank, cap - 1)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    rx = torch.zeros((cap, d), dtype=x.dtype, device=dev).index_add(
        0, slot, torch.where(keep[:, None], x[tok_of], zero))
    # each slot's expert, ``e`` (the reference's empty sentinel) where none
    re = torch.full((cap,), e, dtype=torch.int64, device=dev).scatter_reduce(
        0, slot, torch.where(keep, flat_idx, e), "amin")

    # 4. group by expert (stable sort), ``c2`` rows an expert
    tg = cap
    order2 = torch.sort(re, stable=True).indices
    re_s = re[order2]
    cnt = torch.bincount(re_s, minlength=e + 1)
    st = torch.cumsum(cnt, 0) - cnt
    rank2 = torch.arange(tg, device=dev) - st[re_s]
    keep2 = (rank2 < c2) & (re_s < e)
    slot2 = torch.where(keep2, rank2, c2 - 1)
    eid2 = torch.where(keep2, re_s, 0)
    flat2 = eid2 * c2 + slot2
    xg = torch.zeros((e * c2, d), dtype=x.dtype, device=dev).index_add(
        0, flat2, torch.where(keep2[:, None], rx[order2], zero))
    yg = _experts(params, xg.view(e, c2, d), cfg).reshape(e * c2, d)

    # 5. each row back to its packed slot; 6. the weighted combine at the
    # token (k additions from zero, in choice order)
    ry = torch.zeros((tg, d), dtype=x.dtype, device=dev).index_add(
        0, order2, torch.where(keep2[:, None], yg[flat2], zero))
    contrib = torch.where(keep[:, None], ry[slot] * flat_w[:, None], zero)
    return torch.zeros((n_tok, d), dtype=x.dtype, device=dev).index_add(
        0, tok_of, contrib)


def moe_ep(params, x: Tensor, cfg) -> Tuple[Tensor, Tensor]:
    """The sort-based dispatch on one device: ``x [B, S, d]`` -> ``(y,
    aux)``, with the reference's capacities for ``B * S`` local tokens."""
    b, s, d = x.shape
    weights, idx, aux = router(params, x, cfg)
    y = _ep_local(x.reshape(b * s, d), weights.reshape(b * s, -1),
                  idx.reshape(b * s, -1), params, cfg)
    return y.reshape(b, s, d), aux


MOE_IMPLS = ("dense", "ep_a2a")


def moe_apply(params, x: Tensor, cfg, *, impl: str = "ep_a2a"
              ) -> Tuple[Tensor, Tensor]:
    """``impl="dense"``: :func:`moe_dense`; ``"ep_a2a"`` (the reference's
    default): :func:`moe_ep`."""
    if impl == "dense":
        return moe_dense(params, x, cfg)
    if impl != "ep_a2a":
        raise ValueError(f"moe_impl must be one of {MOE_IMPLS}, got {impl!r}")
    return moe_ep(params, x, cfg)
