"""AdamW with float32, bfloat16 or int8 optimizer state: a twin of
``repro.optim.adamw``.

* ``state_dtype="int8"`` -- each moment of a leaf with more than 4,096
  elements and two or more axes is stored as int8 with a per-row
  (last-axis) float32 scale, after signed-sqrt companding (8-bit Adam);
  smaller leaves stay float32;
* decoupled weight decay on matrices only (two or more axes), global-norm
  clipping, cosine / linear / constant schedules after a linear warmup.

The state mirrors the parameter tree leaf by leaf (:mod:`repro_torch.
tree`): ``{"m", "v", "step"}``, a quantised moment a ``{"q", "scale"}``
dict.  Scalars are float32 tensors on the parameters' device, as the
reference computes them: the bias corrections ``1 - b ** step`` with
``step`` in float32.  Its arithmetic is XLA's in the reference's jitted
step on the CPU: every division by a constant a product with the float32
reciprocal (:func:`repro_torch.core.aimc.mul_reciprocal`), and each
``a * b + c`` of the moment, decay and parameter updates one fused
multiply-add (:func:`repro_torch.core.aimc.fma`).  A layer-stacked leaf is
updated whole: its rows quantise independently, so that equals the
reference's per-layer chunks.

On a ``(data, model)`` training mesh a rank updates its cut of each leaf
(``cuts``: the mesh axes each leaf is cut over, from its placement): the
global gradient norm sums each cut leaf's squares over the ranks that cut
it (a whole leaf counts once), an int8 moment's row scale is the largest
over the ranks that cut its last axis, and whether a leaf's moments
quantise is decided by the whole leaf's size.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as TR
from repro_torch.core.aimc import fma, mul_reciprocal

Tensor = torch.Tensor

_QUANT_MIN_SIZE = 4096
# the most elements of a leaf one elementwise update takes at once
_UPDATE_PIECE = 1 << 23


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """A copy of ``repro.optim.adamw.AdamWConfig``."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # float32 | bfloat16 | int8
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # cosine | linear | constant


def _f32(x: float, device) -> Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule_lr(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """The learning rate at ``step`` (an int tensor): warmup, then the
    schedule's decay over ``total_steps``."""
    s = step.to(torch.float32)
    one = _f32(1.0, s.device)
    warm = torch.minimum(mul_reciprocal(s, max(cfg.warmup_steps, 1)), one)
    frac = torch.clamp(mul_reciprocal(
        s - cfg.warmup_steps, max(cfg.total_steps - cfg.warmup_steps, 1)),
        0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(_f32(math.pi, s.device) * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = one
    return cfg.lr * warm * decay


# ---------------------------------------------------------------------------
# int8 moments
# ---------------------------------------------------------------------------


def _quantised(p: Tensor, whole_numel: Optional[int] = None) -> bool:
    n = p.numel() if whole_numel is None else whole_numel
    return n > _QUANT_MIN_SIZE and p.dim() >= 2


def _is_q(x: Any) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _q_enc(x: Tensor, row_max=None) -> Dict[str, Tensor]:
    """Row-wise int8 of ``sign(x) sqrt(|x|)`` (signed-sqrt companding:
    the second moment's spread within a row fits 8 bits); ``row_max``
    takes a cut row's largest over the ranks that hold its pieces."""
    y = torch.sign(x) * torch.sqrt(torch.abs(x))
    amax = torch.amax(torch.abs(y), dim=-1)
    if row_max is not None:
        amax = row_max(amax)
    scale = torch.where(amax > 0, mul_reciprocal(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(y / scale[..., None]), -127, 127)
    return {"q": q.to(torch.int8), "scale": scale.to(torch.float32)}


def _q_dec(s: Dict[str, Tensor]) -> Tensor:
    y = s["q"].to(torch.float32) * s["scale"][..., None]
    return torch.sign(y) * y * y


def _state_dtype(dtype: str) -> torch.dtype:
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _moment_zero(p: Tensor, dtype: str):
    if dtype == "int8" and _quantised(p):
        return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                "scale": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                     device=p.device)}
    return torch.zeros(p.shape, dtype=_state_dtype(dtype), device=p.device)


# ---------------------------------------------------------------------------
# Optimizer API
# ---------------------------------------------------------------------------


def init_opt_state(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments of ``cfg.state_dtype`` and ``step`` 0 (int32), on the
    parameters' device."""
    leaves, _ = TR.flatten(params)
    dev = leaves[0].device if leaves else None
    return {
        "m": TR.tree_map(lambda p: _moment_zero(p, cfg.state_dtype), params),
        "v": TR.tree_map(lambda p: _moment_zero(p, cfg.state_dtype), params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: Any, cuts=None, mesh=None) -> Tensor:
    """``sqrt`` of the sum of every leaf's sum of squares, in float32.
    ``cuts`` (one tuple of mesh axes a leaf, in flattening order): a cut
    leaf's squares are summed over the ranks of its axes of ``mesh``."""
    leaves, _ = TR.flatten(tree)
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves]
    if not cuts or not any(cuts):
        return torch.sqrt(torch.sum(torch.stack(sq)))
    by_axes: Dict[tuple, list] = {}
    for x, axes in zip(sq, cuts):
        by_axes.setdefault(tuple(axes), []).append(x)
    total = None
    for axes, xs in by_axes.items():
        part = mesh.all_reduce(torch.sum(torch.stack(xs)), axes)
        total = part if total is None else total + part
    return torch.sqrt(total)


def _row_max(mesh, axis: str):
    return lambda amax: mesh.all_reduce(
        amax.clone(), (axis,), torch.distributed.ReduceOp.MAX)


def apply_updates(params: Any, grads: Any, state: Dict[str, Any],
                  cfg: AdamWConfig, *, cuts=None, mesh=None,
                  donate: bool = False
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, Tensor]]:
    """One AdamW step -> ``(params, state, {"grad_norm", "lr"})``; the
    inputs are not modified unless ``donate``: then the new parameters
    and moments are written into the given tensors (JAX's buffer
    donation: no second copy of the state).  ``cuts``/``mesh``: a
    training rank's cut leaves (see the module): each leaf's ``(axes,
    last_axis)``, the mesh axes it is cut over and the one its last axis
    is cut over (or ``None``)."""
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    gn = global_norm(grads, cuts and [c[0] for c in cuts], mesh)
    if cfg.grad_clip > 0:
        clip = torch.minimum(_f32(1.0, gn.device), torch.div(
            _f32(cfg.grad_clip, gn.device), torch.clamp(gn, min=1e-9)))
    else:
        clip = _f32(1.0, gn.device)
    sf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(_f32(cfg.b1, sf.device), sf)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, sf.device), sf)
    qmode = cfg.state_dtype == "int8"

    def upd(p, g, m, v, cut):
        axes, last = cut
        whole = p.numel() * math.prod(mesh.axis_size(a) for a in axes)
        qstate = qmode and _quantised(p, whole)
        if qstate or p.numel() <= _UPDATE_PIECE:
            got = upd_piece(p, g, m, v, qstate, p.dim() >= 2,
                            _row_max(mesh, last) if last else None)
            if not donate:
                return got
            for dst, src in zip((p, m, v), got):
                if isinstance(dst, dict):
                    for k in dst:
                        dst[k].copy_(src[k])
                else:
                    dst.copy_(src)
            return p, m, v
        # elementwise: a flat piece at a time bounds the temporaries (the
        # fused multiply-adds' float64) by the piece, not the leaf
        out = ((p, m, v) if donate else
               [torch.empty(p.shape, dtype=x.dtype, device=p.device)
                for x in (p, m, v)])
        flat = [x.reshape(-1) for x in (p, g, m, v)]
        dst = [o.view(-1) for o in out]
        for a in range(0, p.numel(), _UPDATE_PIECE):
            got = upd_piece(*(x[a:a + _UPDATE_PIECE] for x in flat), False,
                            p.dim() >= 2, None)
            for o, x in zip(dst, got):
                o[a:a + x.numel()] = x
        return tuple(out)

    def upd_piece(p, g, m, v, qstate, decay, row_max):
        gf = g.to(torch.float32) * clip
        mf = _q_dec(m) if qstate else m.to(torch.float32)
        vf = _q_dec(v) if qstate else v.to(torch.float32)
        mf = fma(cfg.b1, mf, (1.0 - cfg.b1) * gf)
        vf = fma(cfg.b2, vf, (1.0 - cfg.b2) * gf * gf)
        mhat = mf / b1c
        vhat = vf / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.to(torch.float32)
        if decay:  # decoupled weight decay on matrices only
            delta = fma(cfg.weight_decay, pf, delta)
        new_p = fma(-lr, delta, pf).to(p.dtype)
        if qstate:
            return new_p, _q_enc(mf, row_max), _q_enc(vf, row_max)
        return new_p, mf.to(m.dtype), vf.to(v.dtype)

    flat_p, structure = TR.flatten(params)
    flat_g = TR.flatten_up_to(structure, grads)
    flat_m = TR.flatten_up_to(structure, state["m"])
    flat_v = TR.flatten_up_to(structure, state["v"])
    flat_c = cuts or [((), None)] * len(flat_p)
    out = [upd(p, g, m, v, c) for p, g, m, v, c in zip(flat_p, flat_g,
                                                         flat_m, flat_v,
                                                         flat_c)]
    new_p = TR.unflatten(structure, [o[0] for o in out])
    new_m = TR.unflatten(structure, [o[1] for o in out])
    new_v = TR.unflatten(structure, [o[2] for o in out])
    new_state = {**state, "m": new_m, "v": new_v, "step": step}
    return new_p, new_state, {"grad_norm": gn, "lr": lr}
