"""The LM stack's float layers: norms, rotary embedding, attention (global,
sliding-window, flash and banded), the decode attention over a per-slot
KV cache, the MLP, embedding and unembedding.

Twins of ``repro/models/layers.py`` (lines 69-86, 95-231, 256-392 and
400-412).  These are float boundaries: the port's values agree with XLA's
to float32 rounding, not bit for bit.  The reference's products are plain
einsums, outside any Pallas kernel, so here they are ``torch.einsum`` and
``torch.matmul``; ``repro_torch.serving`` turns TF32 off for float32
matmuls on the card.  The reference's ``lax.scan`` over KV blocks (flash)
and Q blocks (banded local) are Python loops with the same arithmetic.

On a training mesh (``pctx``: :func:`repro_torch.parallel.sharding.
make_pctx`) :func:`attention` and :func:`mlp` run on a rank's cut: a
rank's heads (Q/K/V by columns, the out-projection by rows; RoPE and the
GQA grouping act on the rank's heads as on any others) and a rank's
``ffn`` columns.  Each cut part is Megatron's pair: its input through
:meth:`repro_torch.launch.mesh.ServingMesh.copy_to_model` (the model
group's cotangents summed), its output through ``reduce_from_model`` (the
rows' partial products summed).  Where ``model`` divides the query heads
but not the KV heads, a rank attends its query heads against the KV
groups they read, projected with the whole KV weights.  With the
vocabulary cut over ``model``, :func:`embed` and :func:`unembed` take the
rank's vocabulary block.  A leaf held whole is computed whole on every
rank.

``attention_decode`` updates the cache **in place** (the new K/V row at
each slot's position, ``pos += 1``) and returns it, as the port's spiking
decode does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# the reference's switch points (``layers.py:178-179``)
FLASH_BLOCK = 1024
FLASH_MIN_SEQ = 2048
_NEG = -1e30  # the reference's mask fill


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotate ``x [..., S, H, D]`` by ``positions [..., S]``
    (broadcastable), in float32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # [D/2]
    angles = positions[..., :, None, None].to(torch.float32) * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, global + sliding-window), train/prefill and decode paths
# ---------------------------------------------------------------------------


def _proj_qkv(params, x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The Q/K/V projections (and ``qkv_bias``'s biases), before RoPE."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(x.dtype))
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return q, k, v


def _qkv(params, x: Tensor, positions: Tensor, cfg
         ) -> Tuple[Tensor, Tensor, Tensor]:
    q, k, v = _proj_qkv(params, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _softcap(scores: Tensor, softcap: float) -> Tensor:
    return torch.tanh(scores / softcap) * softcap if softcap > 0 else scores


def _sdpa(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor],
          softcap: float) -> Tensor:
    """Grouped scaled-dot-product attention: ``q [B,S,H,D]``, ``k``/``v
    [B,L,K,D]``, ``mask`` broadcastable to ``[B,K,G,S,L]``.  The softmax
    runs in float32 and its weights are cast back to ``q.dtype``."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    scores = torch.einsum("bskgd,blkd->bkgsl", qg, k).to(torch.float32)
    scores = _softcap(scores / math.sqrt(d), softcap)
    if mask is not None:
        scores = torch.where(mask, scores, _NEG)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgsl,blkd->bskgd", w, v)
    return out.reshape(b, s, h, d)


def causal_mask(s: int, l: int, offset: int = 0, device=None) -> Tensor:
    """``[s, l]``: query ``i`` attends to key ``j`` iff ``j <= i + offset``."""
    qi = torch.arange(s, device=device)[:, None] + offset
    kj = torch.arange(l, device=device)[None, :]
    return kj <= qi


def window_mask(s: int, l: int, window: int, offset: int = 0,
                device=None) -> Tensor:
    qi = torch.arange(s, device=device)[:, None] + offset
    kj = torch.arange(l, device=device)[None, :]
    return (kj <= qi) & (kj > qi - window)


def _flash_attention(q: Tensor, k: Tensor, v: Tensor, softcap: float, *,
                     window: int = 0, blk: int = FLASH_BLOCK) -> Tensor:
    """Online-softmax (flash) causal attention, a loop over KV blocks of
    ``blk``: the ``[S, S]`` score matrix is never held, the score block
    ``[B,K,G,S,blk]`` is the peak transient."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, d)
    scale = 1.0 / math.sqrt(d)
    q_pos = torch.arange(s, device=q.device)
    m = torch.full((b, kvh, g, s), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s, kvh, g, d), dtype=q.dtype, device=q.device)
    for j in range(s // blk):
        k_j, v_j = k[:, j * blk:(j + 1) * blk], v[:, j * blk:(j + 1) * blk]
        k_pos = j * blk + torch.arange(blk, device=q.device)
        sblk = torch.einsum("bskgd,blkd->bkgsl", qg, k_j).to(torch.float32) * scale
        sblk = _softcap(sblk, softcap)
        mask = k_pos[None, :] <= q_pos[:, None]
        if window:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        sblk = torch.where(mask, sblk, _NEG)
        m_new = torch.maximum(m, torch.amax(sblk, dim=-1))
        p = torch.exp(sblk - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgsl,blkd->bskgd", p.to(q.dtype), v_j)
        acc = acc * corr.movedim(3, 1)[..., None].to(q.dtype) + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-20).movedim(3, 1)[..., None].to(q.dtype)
    return out.reshape(b, s, h, d)


def _banded_local(q: Tensor, k: Tensor, v: Tensor, cfg, window: int) -> Tensor:
    """Sliding-window attention, a loop over Q blocks of ``window``: each
    block attends to itself and its predecessor (``O(S * 2w)``, one ``[w,
    2w]`` score block at a time)."""
    b, s, h, d = q.shape
    base = window_mask(window, 2 * window, window, offset=window,
                       device=q.device)
    first = base & (torch.arange(2 * window, device=q.device)[None, :] >= window)
    zeros = torch.zeros_like(k[:, :window])
    out = []
    for i in range(s // window):
        cur = slice(i * window, (i + 1) * window)
        prev = slice((i - 1) * window, i * window)
        kk = torch.cat([zeros if i == 0 else k[:, prev], k[:, cur]], dim=1)
        vv = torch.cat([zeros if i == 0 else v[:, prev], v[:, cur]], dim=1)
        mask = first if i == 0 else base
        out.append(_sdpa(q[:, cur], kk, vv, mask[None, None, None],
                         cfg.attn_softcap))
    return torch.cat(out, dim=1)


def cut_mesh(pctx, leaf: Tensor, axis: int, whole: int):
    """The training mesh when ``leaf`` holds a rank's cut of its ``axis``
    (``whole`` long uncut), else ``None``."""
    if pctx is None or not getattr(pctx, "train", False):
        return None
    return pctx.mesh if leaf.shape[axis] != whole else None


def own_kv_groups(params, cfg, mesh):
    """Where ``model`` cuts the query heads but not the KV heads (which it
    does not divide): the KV projections of the groups the rank's query
    heads read, taken from the whole ones after
    :meth:`repro_torch.launch.mesh.ServingMesh.copy_to_model` (each rank's
    heads give a partial gradient of the whole leaf, summed over the
    group).  The rank's heads are a whole number of groups, or lie in
    one."""
    kv, h = cfg.num_kv_heads, cfg.num_heads
    if params["wk"].shape[-2] != kv:
        return params  # both head axes cut
    hl = params["wq"].shape[-2]
    g = h // kv
    if hl % g and g % hl:
        raise NotImplementedError(
            f"{hl} query heads a rank straddle the KV groups of {g} heads")
    h0 = mesh.model_index * hl
    lo, hi = h0 // g, (h0 + hl - 1) // g + 1
    out = dict(params)
    for name in ("wk", "wv", "bk", "bv"):
        if name in params:
            out[name] = mesh.copy_to_model(params[name])[..., lo:hi, :]
    return out


def attention(params, x: Tensor, positions: Tensor, cfg, *,
              window: int = 0, pctx=None) -> Tensor:
    """Causal (or sliding-window) self-attention for train/prefill: the
    banded Q-block loop for a windowed layer longer than two windows, the
    flash loop from ``FLASH_MIN_SEQ`` tokens, the masked einsum below.
    On a training mesh's cut, the rank's heads (see the module; with whole
    KV heads, the groups its query heads read: :func:`own_kv_groups`)."""
    b, s, _ = x.shape
    mesh = cut_mesh(pctx, params["wq"], -2, cfg.num_heads)
    if mesh is not None:
        x = mesh.copy_to_model(x)
        params = own_kv_groups(params, cfg, mesh)
    q, k, v = _qkv(params, x, positions, cfg)
    blk = FLASH_BLOCK
    while blk > 128 and s % blk:
        blk //= 2
    if window and s > 2 * window and s % window == 0:
        out = _banded_local(q, k, v, cfg, window)
    elif s >= FLASH_MIN_SEQ and s % blk == 0:
        out = _flash_attention(q, k, v, cfg.attn_softcap, window=window,
                               blk=blk)
    else:
        m = (window_mask(s, s, window, device=x.device) if window
             else causal_mask(s, s, device=x.device))
        out = _sdpa(q, k, v, m[None, None, None], cfg.attn_softcap)
    out = torch.einsum("bshd,hdk->bsk", out, params["wo"].to(x.dtype))
    return out if mesh is None else mesh.reduce_from_model(out)


def attention_decode(params, x: Tensor, cache: Dict[str, Tensor], cfg, *,
                     window: int = 0) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode over the per-slot KV cache ``{"k", "v": [B,L,K,D],
    "pos": [B] int32}``: ``pos`` is each slot's count of valid tokens, so
    slots at different positions decode together; a windowed layer's cache
    is a ring buffer of ``window`` rows.  The new K/V row is written in
    place and ``pos`` advanced; returns ``(y [B,1,D], cache)``."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"attention_decode takes one token, not {s}")
    pos = cache["pos"].expand(b).to(torch.int64)
    q, k, v = _proj_qkv(params, x)
    positions = pos[:, None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    L = ck.shape[1]
    slot = pos % window if window else pos
    rows = torch.arange(b, device=x.device)
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    idx = torch.arange(L, device=x.device)
    if window:
        valid = idx[None, :] < torch.clamp(pos + 1, max=L)[:, None]
    else:
        valid = idx[None, :] <= pos[:, None]
    out = _sdpa(q, ck.to(q.dtype), cv.to(q.dtype),
                valid[:, None, None, None, :], cfg.attn_softcap)
    cache["pos"] += 1
    return torch.einsum("bshd,hdk->bsk", out, params["wo"].to(x.dtype)), cache


def attention_cache(cfg, batch: int, seq_len: int, device, *,
                    window: int = 0, lead: Tuple[int, ...] = ()
                    ) -> Dict[str, Tensor]:
    """A zero KV cache (``attention_cache_schema``): ``window`` rows for a
    windowed layer (at most ``seq_len``), ``lead`` stacking axes first."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    L = min(window, seq_len) if window else seq_len
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return {"k": torch.zeros(lead + (batch, L, kv, hd), dtype=dt, device=device),
            "v": torch.zeros(lead + (batch, L, kv, hd), dtype=dt, device=device),
            "pos": torch.zeros(lead + (batch,), dtype=torch.int32,
                               device=device)}


# ---------------------------------------------------------------------------
# MLP (dense feed-forward)
# ---------------------------------------------------------------------------


def _act(kind: str, x: Tensor) -> Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def mlp(params, x: Tensor, cfg, pctx=None) -> Tensor:
    """The (gated) MLP; on a training mesh's cut, the rank's ``ffn``
    columns (see the module)."""
    mesh = cut_mesh(pctx, params["wo"], -2,
                     cfg.moe_dense_ff if cfg.is_moe else cfg.d_ff)
    if mesh is not None:
        x = mesh.copy_to_model(x)
    h = x @ params["wi"].to(x.dtype)
    if "wg" in params:
        h = _act(cfg.act, x @ params["wg"].to(x.dtype)) * h
    else:
        h = _act(cfg.act, h)
    out = h @ params["wo"].to(x.dtype)
    return out if mesh is None else mesh.reduce_from_model(out)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed(params, tokens: Tensor, dtype, mesh=None) -> Tensor:
    """The table's rows at ``tokens``; ``mesh``: the table is the rank's
    block of the vocabulary (rows ``model_index * n ..``), which looks up
    the tokens it holds, zeros the others and sums over the model group
    (one rank gives each row: exact)."""
    table = params["table"].to(dtype)
    if mesh is None:
        return table[tokens]
    n = table.shape[0]
    local = tokens.long() - mesh.model_index * n
    mine = ((local >= 0) & (local < n))[..., None]
    rows = table[local.clamp(0, n - 1)]
    return mesh.reduce_from_model(torch.where(mine, rows, 0.0).to(dtype))


def unembed(params, x: Tensor, cfg, mesh=None) -> Tensor:
    """The logits, softcapped where the config asks; ``mesh``: ``w`` is
    the rank's block of the vocabulary columns, and so are the logits."""
    if mesh is not None:
        x = mesh.copy_to_model(x)
    logits = torch.matmul(x, params["w"].to(x.dtype))
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits
