"""Mixture-of-Experts: a twin of ``repro/models/moe.py``.

* :func:`router` -- the float32 softmax over the experts, its top-k
  (ties to the lower expert, as ``lax.top_k`` breaks them), the weights
  renormalised and cast back to the input dtype, and the Switch
  load-balancing loss ``E * sum(mean(probs) * mean(choices per expert))``;
* :func:`moe_dense` -- every expert on every token, combined through the
  one-hot of the choices (the reference's smoke-test path);
* :func:`moe_ep` -- the reference's sort-based dispatch (``_ep_local``).
  On one device: one destination column, no collective.  The ``(token,
  choice)`` pairs pack into a buffer of ``cap = round_up(int(T * k *
  capacity_factor / tp) + 1, 8)`` rows a destination column, then group
  by expert into ``C2`` rows an expert; a choice past either capacity is
  dropped (its slot takes ``+0``), so this is not :func:`moe_dense`
  unless the capacities hold every choice.

On a training mesh (:class:`ParallelCtx` with ``train``, from
:func:`repro_torch.parallel.sharding.make_pctx`) :func:`moe_ep` is the
reference's ``shard_map`` body on the rank's own token block: its batch
rows, and its block of the sequence over ``model`` where the reference's
``seq_ok`` holds (the block split off under autograd and gathered back
after the dispatch).  The capacities are the reference's per-device ones,
from that block's token count, so a rank's share of a step is not one
device's step on its rows.  The all-to-alls carry gradients, every sender
gets its own rows back, and the experts' ``d_ff``, cut over ``data`` with
``fsdp``, is un-cut by the reference's choice (``moe.py:282-286``): the
weights all-gathered over ``data`` (their gradient reduce-scattered
back), or the received rows all-gathered and the outputs'
``psum_scatter``.  The router sees the rank's tokens only, so its
load-balancing statistics (``mean(probs)`` and the choice counts) are
averaged over the ranks that split the batch's tokens before their
product: the reference's router runs on the whole batch.

On a serving mesh (:class:`ParallelCtx`) each rank of a model group holds
``E / tp`` experts, a contiguous block (``convert.shard_params``), and
:func:`moe_ep` is the reference's ``shard_map`` body on the rank's own
tokens: the pairs sort by destination column (``idx // E_l``) into ``tp``
send buffers of ``cap`` rows, an all-to-all over the model group
(:meth:`repro_torch.launch.mesh.ServingMesh.all_to_all_model`) brings each
column its rows, ``C2`` applies over the ``tp * cap`` rows received, the
column's experts run, and a second all-to-all returns the rows to their
senders, which combine them.  Every rank of a model group routes the same
tokens (the reference splits them over ``data`` only), so a column
receives ``tp`` copies of each, and the copies count against ``C2`` as in
the reference.  ``C2`` keeps sender 0's copies first, so where it drops,
the group's senders would combine different outputs; the reference's
``shard_map`` declares its output whole over ``model`` and holds sender
0's, and so every rank here takes sender 0's results.  There is no FSDP
axis: the serving mesh has none (the weight and token gathers are
training's).  With ``whole_batch`` the ranks route the
whole batch with one device's capacities and only the expert products
split (the reference's mesh forward, which passes no ``pctx``).

The expert products are plain ``einsum`` (the reference's are plain
``jnp`` outside any Pallas kernel); ``index_add`` and ``scatter_reduce
("amin")`` take the place of ``.at[].add`` and ``.at[].min``.  Gradients
flow through autograd off a mesh.  :data:`DISPATCH` counts drops and
all-to-alls when enabled.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _act

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """Where a MoE block's tokens and experts are: the twin of the
    reference's ``ParallelCtx``: on the serving mesh ``dp_axes=("data",)``,
    ``tp_axis="model"``, no FSDP axis, no sequence split; on a training
    mesh (``train``) the reference's ``make_pctx`` (see the fields).

    mesh  -- the rank's :class:`repro_torch.launch.mesh.ServingMesh`
             (``None``: one device), whose ``data`` ranks split the batch
             (a rank's tokens are already its own share) and whose model
             group of ``tp`` ranks holds ``E / tp`` experts a rank;
    whole_batch -- every rank routes the whole batch with one device's
             capacities (the mesh forward); otherwise the all-to-all
             dispatch over the model group."""

    mesh: Any = None
    whole_batch: bool = False
    # training (``train``): the reference's ``make_pctx`` on the mesh --
    # the batch rows over ``data`` (``pure_dp``: over every rank, with
    # no model axis), the experts' d_ff over ``data`` (``fsdp``), a MoE
    # block's tokens over ``model`` by sequence (``seq_shard``)
    train: bool = False
    fsdp: bool = False
    seq_shard: bool = False
    pure_dp: bool = False

    @property
    def tp(self) -> int:
        if self.mesh is None or self.pure_dp:
            return 1
        return self.mesh.model

    @property
    def fs(self) -> int:
        """The FSDP axis's size (the reference's ``fsdp_size``)."""
        return self.mesh.data if (self.mesh is not None and self.fsdp) else 1

    def token_axes(self, seq_split: bool) -> Tuple[str, ...]:
        """The mesh axes whose ranks hold different tokens of a training
        batch: ``data``, and ``model`` where a MoE block splits the
        sequence (or ``pure_dp`` splits rows over it)."""
        if not self.train:
            return ()
        return ("data", "model") if (seq_split or self.pure_dp) else ("data",)


@dataclasses.dataclass
class DispatchStats:
    """What the dispatch did since :meth:`reset`, when ``enabled``: the
    dispatches, the choices dropped past ``cap`` and past ``C2`` (device
    tensors summed without a host sync until :meth:`read`), and the
    all-to-alls and their bytes, by the dispatch's local token count."""

    enabled: bool = False
    drops: Optional[Tensor] = None  # [past_cap, past_c2]
    by_tokens: Dict[int, Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    def reset(self, enabled: bool = True) -> None:
        self.enabled, self.drops, self.by_tokens = enabled, None, {}

    def _note(self, n_tok: int, drops: Tensor, a2a: int, nbytes: int,
              gathers: int = 0, gather_bytes: int = 0,
              branch: Optional[str] = None) -> None:
        self.drops = drops if self.drops is None else self.drops + drops
        row = self.by_tokens.setdefault(
            n_tok, {"dispatches": 0, "all_to_alls": 0, "a2a_bytes": 0})
        row["dispatches"] += 1
        row["all_to_alls"] += a2a
        row["a2a_bytes"] += nbytes
        if branch is not None:  # training's FSDP un-cut (forward only)
            row["gathers"] = row.get("gathers", 0) + gathers
            row["gather_bytes"] = row.get("gather_bytes", 0) + gather_bytes
            row.setdefault("branches", []).append(branch)

    def read(self) -> Dict[str, Any]:
        past = [0, 0] if self.drops is None else self.drops.tolist()
        return {"past_cap": int(past[0]), "past_c2": int(past[1]),
                "by_tokens": {k: dict(v) for k, v in self.by_tokens.items()}}


DISPATCH = DispatchStats()


def moe_schema(cfg) -> Dict[str, Any]:
    """``router [d, E]``, ``wi``/``wg [E, d, f]``, ``wo [E, f, d]`` as
    ``(shape, init)`` (``wg`` with a gated MLP)."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    s = {"router": ((d, e), "normal"), "wi": ((e, d, f), "normal"),
         "wo": ((e, f, d), "normal")}
    if cfg.gated_mlp:
        s["wg"] = ((e, d, f), "normal")
    return s


def expert_block(num_experts: int, model: int) -> int:
    """Experts a rank of a ``model`` group holds: ``E / model``."""
    if num_experts % model:
        raise ValueError(f"{num_experts} experts do not split over "
                         f"model={model} ranks: the expert-parallel "
                         "dispatch holds E / model experts a rank")
    return num_experts // model


def router(params, x: Tensor, cfg, pctx: Optional[ParallelCtx] = None,
           seq_split: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """Top-k routing of ``x [..., d]`` -> ``(weights [..., k] in x's
    dtype, idx [..., k] int64, aux)``.  On a training mesh ``x`` is the
    rank's tokens (``seq_split``: its sequence block too), and
    ``mean(probs)`` and the mean choice counts are averaged over the
    ranks that split the batch (equal blocks) before their product, as
    the reference's router takes them over the whole batch;
    ``mean(probs)``'s average keeps its gradient (each rank's share gets
    the product's cotangent)."""
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
    axes = pctx.token_axes(seq_split) if pctx is not None else ()
    if axes:
        mesh = pctx.mesh
        n = math.prod(mesh.axis_size(a) for a in axes)
        me = mesh.reduce_tokens(me, axes) * (1.0 / n)
        ce = mesh.reduce_tokens(ce.detach(), axes) * (1.0 / n)
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


def _own_experts(params, cfg, tp: int):
    """The expert leaves of a rank's block, as the placement cut them
    (:func:`repro_torch.convert.shard_params`, or drawn as the block)."""
    n = expert_block(cfg.num_experts, tp)
    for k, v in params.items():
        if k != "router" and v.shape[-3] != n:
            raise ValueError(f"moe.{k} holds {v.shape[-3]} experts, not a "
                             f"rank's block of {n}: place the tree first")
    return params


def _uncut_experts(params, cfg, pctx: Optional[ParallelCtx]):
    """A training rank's expert leaves with their ``d_ff`` gathered over
    ``data`` where FSDP cut it (the gradient reduce-scattered back)."""
    if pctx is None or not pctx.train or pctx.fs <= 1:
        return params
    out = dict(params)
    for k in ("wi", "wg", "wo"):
        if k in out and out[k].shape[-1 if k != "wo" else -2] != cfg.d_ff:
            out[k] = pctx.mesh.all_gather(out[k], -1 if k != "wo" else -2,
                                          "data")
    return out


def moe_dense(params, x: Tensor, cfg, pctx: Optional[ParallelCtx] = None
              ) -> Tuple[Tensor, Tensor]:
    """Every expert on every token of ``x [B, S, d]``, combined with the
    router's top-k weights -> ``(y [B, S, d], aux)``.  On a training mesh
    (``pctx``) ``x`` is the rank's rows and the experts must be whole over
    ``model`` (the FSDP-cut ``d_ff`` is gathered first)."""
    if pctx is not None and pctx.train and \
            params["wi"].shape[-3] != cfg.num_experts:
        raise NotImplementedError(
            f"moe_impl='dense' on a training mesh that cuts the experts "
            f"over model={pctx.tp}: train with moe_impl='ep_a2a'")
    weights, idx, aux = router(params, x, cfg, pctx)
    dt = x.dtype
    params = _uncut_experts(params, cfg, pctx)
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


def capacities(n_tok: int, cfg, tp: int = 1, rows_from: int = 1
               ) -> Tuple[int, int]:
    """The dispatch's two capacities for ``n_tok`` local tokens on a model
    group of ``tp`` ranks (one device: ``tp = 1``): ``cap`` rows of packed
    ``(token, choice)`` pairs a destination column, and ``c2`` rows an
    expert over the ``rows_from * tp * cap`` rows a column groups
    (``rows_from``: the data ranks whose received rows a token gather
    brings together) -- the reference's, with its Python ``int`` of a
    float."""
    e_l = max(cfg.num_experts // tp, 1)
    cap = _round_up(int(max(n_tok, 1) * cfg.moe_top_k * cfg.capacity_factor
                        / tp) + 1, 8)
    tg = rows_from * tp * cap
    return cap, _round_up(min(tg, max(int(tg // e_l * 1.25), 8)), 8)


def token_gather(cfg, cap: int, tp: int, fs: int, gated: bool) -> bool:
    """The reference's un-cut choice (``moe.py:282-286``): gather the
    routed rows (and ``psum_scatter`` the outputs) when their bytes, ``2 *
    fs * tp * cap * d``, are fewer than the rank's expert weights', ``E /
    tp * d * d_ff * n_mats``; else gather the weights."""
    n_mats = 3 if gated else 2
    weight_bytes = (cfg.num_experts // max(tp, 1)) * cfg.d_model * cfg.d_ff \
        * n_mats
    return 2 * fs * tp * cap * cfg.d_model < weight_bytes


def _ep_local(x: Tensor, weights: Tensor, idx: Tensor, params, cfg,
              pctx: Optional[ParallelCtx] = None) -> Tensor:
    """The reference's ``_ep_local``: ``x [T, d]``, ``weights``/``idx [T,
    k]`` (global expert ids) -> ``y [T, d]``.  One device, a serving rank
    of a model group holding its ``E / tp`` experts (:class:`ParallelCtx`:
    the all-to-all dispatch, or ``whole_batch``), or a training rank (its
    own token block, the FSDP un-cut, gradients through every
    collective)."""
    n_tok, d = x.shape
    k, e = cfg.moe_top_k, cfg.num_experts
    dev = x.device
    pctx = pctx or ParallelCtx()
    mesh, tp = pctx.mesh, pctx.tp
    train = pctx.train
    split = tp > 1 and pctx.whole_batch  # one device's dispatch, experts cut
    if tp > 1:
        params = _own_experts(params, cfg, tp)
    m = 1 if split else tp  # destination columns
    e_l = e // m
    fs = pctx.fs if train else 1
    gated = "wg" in params
    gather = None  # training's FSDP un-cut: "tokens" or "weights"
    if fs > 1:
        cap = capacities(n_tok, cfg, m)[0]
        gather = ("tokens" if token_gather(cfg, cap, m, fs, gated)
                  else "weights")
    cap, c2 = capacities(n_tok, cfg, m, fs if gather == "tokens" else 1)
    pn = n_tok * k
    zero = torch.zeros((), dtype=x.dtype, device=dev)

    # 1. the (token, choice) pairs sorted (stably) by destination column,
    # ranked within it, packed into ``m`` send buffers of ``cap`` rows; a
    # pair past ``cap`` is dropped onto its column's last slot as +0
    flat_idx = idx.reshape(pn)
    flat_w = weights.reshape(pn)
    tok_of = torch.arange(pn, device=dev) // k
    rank = torch.arange(pn, device=dev)
    if m > 1:  # (one column: the stable sort keeps the pairs in order)
        dest = flat_idx // e_l
        order = torch.sort(dest, stable=True).indices
        dest_s = dest[order]
        cnt = torch.bincount(dest_s, minlength=m)
        rank = rank - (torch.cumsum(cnt, 0) - cnt)[dest_s]
        tok_of, flat_idx, flat_w = (tok_of[order], flat_idx[order] % e_l,
                                    flat_w[order])
    keep = rank < cap
    flat = torch.where(keep, rank, cap - 1)
    if m > 1:
        flat = dest_s * cap + flat
    send_x = torch.zeros((m * cap, d), dtype=x.dtype, device=dev).index_add(
        0, flat, torch.where(keep[:, None], x[tok_of], zero))
    # each slot's expert, ``e_l`` (the reference's empty sentinel) where none
    send_e = torch.full((m * cap,), e_l, dtype=torch.int64,
                        device=dev).scatter_reduce(
        0, flat, torch.where(keep, flat_idx, e_l), "amin")

    # 2. each column's rows from every rank of the group; 3. training's
    # un-cut of the experts' d_ff: the rows or the weights over data
    rx = mesh.all_to_all_model(send_x) if m > 1 else send_x
    re = mesh.all_to_all_model(send_e) if m > 1 else send_e
    gathered = 0
    if gather == "tokens":
        rx = mesh.all_gather(rx, 0, "data")
        re = mesh.all_gather(re, 0, "data")
        gathered = rx.numel() * rx.element_size() * 2  # and the scatter
    elif gather == "weights":
        params = _uncut_experts(params, cfg, pctx)
        gathered = sum(params[n].numel() * params[n].element_size()
                       for n in ("wi", "wg", "wo") if n in params)
    tg = rx.shape[0]

    # 4. group by expert (stable sort), ``c2`` rows an expert
    order2 = torch.sort(re, stable=True).indices
    re_s = re[order2]
    cnt2 = torch.bincount(re_s, minlength=e_l + 1)
    st = torch.cumsum(cnt2, 0) - cnt2
    rank2 = torch.arange(tg, device=dev) - st[re_s]
    real = re_s < e_l
    keep2 = (rank2 < c2) & real
    slot2 = torch.where(keep2, rank2, c2 - 1)
    eid2 = torch.where(keep2, re_s, 0)
    flat2 = eid2 * c2 + slot2
    xg = torch.zeros((e_l * c2, d), dtype=x.dtype, device=dev).index_add(
        0, flat2, torch.where(keep2[:, None], rx[order2], zero))
    if split:
        # the rank's block of experts on its rows; the group sums the
        # blocks in float32 (one rank fills each row: exact)
        n = e // tp
        mine = xg.view(e, c2, d)[mesh.model_index * n:][:n]
        yg = torch.zeros((e, c2, d), dtype=torch.float32,
                         device=mesh.host_device)
        yg[mesh.model_index * n:][:n] = _experts(params, mine, cfg).to(yg)
        yg = mesh.all_reduce_model(yg).to(x).reshape(e * c2, d)
    else:
        yg = _experts(params, xg.view(e_l, c2, d), cfg).reshape(e_l * c2, d)

    # 5. each row back to its packed slot; 6. back to the senders, and the
    # weighted combine at the token
    ry = torch.zeros((tg, d), dtype=x.dtype, device=dev).index_add(
        0, order2, torch.where(keep2[:, None], yg[flat2], zero))
    if gather == "tokens":  # the d_ff-partial outputs summed, rows home
        ry = mesh.reduce_scatter_data(ry, 0)
    if m > 1 and not train:
        # serving: the group's senders packed the same rows, and ``C2``
        # ranks sender 0's copies first: every sender gets sender 0's
        # results, the value the reference's ``shard_map`` output
        # (declared whole over ``model``) holds.  In training each sender
        # sent its own tokens and gets its own rows back.
        ry = ry[:cap].repeat(m, 1)
    back = mesh.all_to_all_model(ry) if m > 1 else ry
    if DISPATCH.enabled:
        drops = torch.stack([(~keep).sum(), (real & ~keep2).sum()])
        a2a = (send_x, send_e, ry) if m > 1 else ()
        DISPATCH._note(n_tok, drops, len(a2a),
                       sum(t.numel() * t.element_size() for t in a2a),
                       gathers={"tokens": 3, "weights": 2 + gated}.get(
                           gather, 0),
                       gather_bytes=gathered,
                       branch=(gather or "none") if train else None)
    contrib = torch.where(keep[:, None], back[flat] * flat_w[:, None], zero)
    return torch.zeros((n_tok, d), dtype=x.dtype, device=dev).index_add(
        0, tok_of, contrib)


def moe_ep(params, x: Tensor, cfg, pctx: Optional[ParallelCtx] = None
           ) -> Tuple[Tensor, Tensor]:
    """The sort-based dispatch: ``x [B, S, d]`` (a mesh rank's own
    tokens) -> ``(y, aux)``, with the reference's capacities for ``B * S``
    local tokens.  On a training mesh with a model axis the rank routes
    its block of the sequence (the reference's ``seq_ok``: ``seq_shard``
    and ``S`` divisible by ``model``), split off and gathered back under
    autograd; the router's weight gets its gradient from every block."""
    pctx = pctx or ParallelCtx()
    b, s, d = x.shape
    seq = pctx.train and pctx.tp > 1
    if seq and not (pctx.seq_shard and s % pctx.tp == 0):
        raise NotImplementedError(
            f"training MoE on model={pctx.tp} without the sequence split "
            f"(seq_shard={pctx.seq_shard}, sequence {s}): the reference's "
            "senders would then route the same tokens and its output keeps "
            "one of them (ROADMAP queue C)")
    if seq:
        x = pctx.mesh.split_model(x, 1)
        params = dict(params, router=pctx.mesh.copy_to_model(
            params["router"]))
    weights, idx, aux = router(params, x, cfg, pctx, seq_split=seq)
    n = x.shape[0] * x.shape[1]
    y = _ep_local(x.reshape(n, d), weights.reshape(n, -1),
                  idx.reshape(n, -1), params, cfg, pctx)
    y = y.reshape(x.shape)
    if seq:
        y = pctx.mesh.all_gather(y, 1, "model")
    return y, aux


MOE_IMPLS = ("dense", "ep_a2a")


def moe_apply(params, x: Tensor, cfg, *, impl: str = "ep_a2a",
              pctx: Optional[ParallelCtx] = None) -> Tuple[Tensor, Tensor]:
    """``impl="dense"``: :func:`moe_dense` (one device, every expert
    whole); ``"ep_a2a"`` (the reference's default): :func:`moe_ep`, on a
    mesh where ``pctx`` places it."""
    if impl == "dense":
        return moe_dense(params, x, cfg, pctx)
    if impl != "ep_a2a":
        raise ValueError(f"moe_impl must be one of {MOE_IMPLS}, got {impl!r}")
    return moe_ep(params, x, cfg, pctx)
