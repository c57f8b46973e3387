"""The spiking decode step of the generic LM stack (SSA serving path).

Twin of the spiking branch of ``repro/models/transformer.py`` (lines
456-528 and 536-767): the per-slot spike-train KV cache, per-slot PRN keys
``f(seed, pos)``, Bernoulli rate coding, the unfused and fused attention
decodes, the FFN tail, and the unembedding.  A Python loop over layers
takes the place of the reference's ``lax.scan`` over the stacked period
axis; parameters and caches keep the reference's stacked layout
(``periods`` leaves carry a leading period axis).

Unlike the reference, the decode updates the cache **in place** (scatter of
the new K/V trains and ``pos += 1``): one step never needs two copies of a
cache that is the largest state on the card.  ``decode_step`` returns the
same cache object it was given.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import aimc_device as AD
from repro_torch import prng
from repro_torch.core import spikes as SP
from repro_torch.kernels.plan import AttnSpec, DecodePlan, KVView
from repro_torch.kernels.ref import scatter_at_pos
from repro_torch.models import layers as L

Tensor = torch.Tensor


def model_dtype(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def spiking_decode_enabled(cfg) -> bool:
    return bool(cfg.spiking) and cfg.attention_kind == "ssa"


def _require_spiking(cfg) -> None:
    if not spiking_decode_enabled(cfg):
        raise NotImplementedError(
            f"{cfg.name}: only the spiking SSA decode path is ported")
    if any(m not in ("attn", "local") for m in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: mixers {cfg.block_pattern} are not ported")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _block_shapes(cfg) -> Dict[str, Any]:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    s: Dict[str, Any] = {
        "norm1": {"scale": (d,)},
        "mixer": {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
                  "wo": (h, hd, d)},
    }
    if cfg.d_ff > 0:
        s["norm2"] = {"scale": (d,)}
        s["mlp"] = {"wi": (d, cfg.d_ff), "wo": (cfg.d_ff, d)}
        if cfg.gated_mlp:
            s["mlp"]["wg"] = (d, cfg.d_ff)
    return s


def _model_shapes(cfg) -> Dict[str, Any]:
    """Leaf shapes of the reference's parameter tree (stacked periods)."""
    period = {f"blk{i}": _block_shapes(cfg) for i in range(cfg.period)}

    def stack(tree, n):
        if isinstance(tree, dict):
            return {k: stack(v, n) for k, v in tree.items()}
        return (n,) + tree

    s: Dict[str, Any] = {
        "embed": {"table": (cfg.vocab_size, cfg.d_model)},
        "final_norm": {"scale": (cfg.d_model,)},
    }
    if cfg.num_periods > 0:
        s["periods"] = stack(period, cfg.num_periods)
    if cfg.remainder_layers:
        s["remainder"] = {f"blk{i}": _block_shapes(cfg)
                          for i in range(cfg.remainder_layers)}
    if not cfg.tie_embeddings:
        s["unembed"] = {"w": (cfg.d_model, cfg.vocab_size)}
    return s


def init_params(cfg, seed: int, device) -> Dict[str, Any]:
    """Random weights from ``seed``: normal with std ``1/sqrt(fan_in)``,
    the fan-in being the input width of one layer's matrix (every axis but
    the output axis: ``h*hd`` for the attention out-projection), norm
    scales one.  Drawn with a CPU ``torch.Generator``, so the values do not
    depend on the device."""
    _require_spiking(cfg)
    gen = torch.Generator().manual_seed(seed)
    dtype = model_dtype(cfg)

    def make(path, shape):
        if path[-1] == "scale":
            return torch.ones(shape, dtype=dtype, device=device)
        per_layer = shape[1:] if path[0] == "periods" else shape
        fan = math.prod(per_layer[:-1])
        w = torch.randn(shape, generator=gen, dtype=torch.float32)
        return (w / math.sqrt(fan)).to(dtype=dtype, device=device)

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else make(path + (k,), v)
                for k, v in sorted(tree.items())}

    return walk(_model_shapes(cfg), ())


def _linear_fan_ins(cfg) -> Dict[Tuple[str, str], int]:
    """(group, name) -> d_in of the spiking linears the decode quantises."""
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    return {("mixer", "wq"): d, ("mixer", "wk"): d, ("mixer", "wv"): d,
            ("mixer", "wo"): h * hd, ("mlp", "wi"): d, ("mlp", "wo"): cfg.d_ff}


def quantize_params(params: Dict[str, Any], cfg) -> Dict[str, Any]:
    """A copy of ``params`` whose spiking-linear weights are replaced by
    their Table-II operands ``{"levels": int8 [.., d_in, d_out], "scale":
    f32 [.., d_out]}``.  The reference quantises float weights inside
    every jitted step; eager PyTorch would redo it on every call, so the
    scheduler does it once -- the same function of the same weights."""
    fan_in = _linear_fan_ins(cfg)

    def block(blk, stacked: bool):
        out = dict(blk)
        for group in ("mixer", "mlp"):
            if group not in blk:
                continue
            g = dict(blk[group])
            for name, w in blk[group].items():
                if (group, name) not in fan_in or isinstance(w, dict):
                    continue
                lead = w.shape[:1] if stacked else ()
                levels, scale = AD.quantize_weights(
                    w.reshape(*lead, fan_in[(group, name)], -1))
                g[name] = {"levels": levels.to(torch.int8), "scale": scale}
            out[group] = g
        return out

    out = dict(params)
    if "periods" in params:
        out["periods"] = {k: block(v, True) for k, v in params["periods"].items()}
    if "remainder" in params:
        out["remainder"] = {k: block(v, False)
                            for k, v in params["remainder"].items()}
    return out


def _take(tree, i: int):
    """Index every tensor leaf of a (stacked) tree at ``i``: views."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def _lin_operand(w, d_in: int):
    """A spiking-linear weight operand: pre-quantised leaves pass through,
    float arrays reshape to the ``[d_in, d_out]`` crossbar view."""
    if isinstance(w, dict):
        return w
    return w.to(torch.float32).reshape(d_in, -1)


# ---------------------------------------------------------------------------
# Spiking KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, seq_len: int, device) -> Dict[str, Any]:
    """Zero per-slot spike-train caches: ``sk``/``sv [B, T, L, KV, hd]``
    uint8 and ``pos [B]`` int32 per attention block (stacked periods get a
    leading period axis).  Positions past ``pos`` hold zero spikes, which
    masks them out of the SSA comparators."""
    _require_spiking(cfg)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def blk(lead):
        shape = lead + (batch, cfg.spike_T, seq_len, kv, hd)
        return {"sk": torch.zeros(shape, dtype=torch.uint8, device=device),
                "sv": torch.zeros(shape, dtype=torch.uint8, device=device),
                "pos": torch.zeros(lead + (batch,), dtype=torch.int32,
                                   device=device)}

    out: Dict[str, Any] = {}
    if cfg.num_periods > 0:
        out["periods"] = {f"blk{i}": blk((cfg.num_periods,))
                          for i in range(cfg.period)}
    if cfg.remainder_layers:
        out["remainder"] = {f"blk{i}": blk(())
                            for i in range(cfg.remainder_layers)}
    return out


def _first_pos(cache) -> Tensor:
    if "periods" in cache:
        return cache["periods"]["blk0"]["pos"][0]
    return cache["remainder"]["blk0"]["pos"]


# ---------------------------------------------------------------------------
# Spiking decode
# ---------------------------------------------------------------------------


def _slot_base_keys(seeds: Tensor, pos: Tensor) -> Tensor:
    """Per-slot PRNG keys ``fold_in(PRNGKey(seed), pos)``: ``[B, 2]``."""
    return prng.fold_in(prng.key_from_seeds(seeds), pos.to(torch.int64))


def _slot_rate_encode(keys: Tensor, x: Tensor, t: int) -> Tensor:
    """Per-slot Bernoulli rate coding: ``x [B,1,d]`` -> ``[T,B,1,d]``."""
    return SP.rate_encode(keys, torch.sigmoid(x.to(torch.float32)), t).movedim(1, 0)


def _spiking_attention_decode(params, s: Tensor, cache, cfg, slot_keys: Tensor,
                              backend) -> Tensor:
    """Unfused one-token SSA decode: Q/K/V spiking linears, scatter of the
    new K/V trains at ``pos`` (in place), one query row over the whole
    cache, attention-out.  ``s [T,B,1,d]``."""
    t, b, _, d = s.shape
    h, hd, kv = cfg.num_heads, cfg.resolved_head_dim, cfg.num_kv_heads

    def proj(w):
        out = backend.spiking_linear(_lin_operand(w, d), s)
        return out.reshape(t, b, -1, hd)

    q = proj(params["wq"])
    k_new = proj(params["wk"])
    v_new = proj(params["wv"])
    pos = cache["pos"]
    scatter_at_pos(cache["sk"], pos, k_new.movedim(0, 1))
    scatter_at_pos(cache["sv"], pos, v_new.movedim(0, 1))
    pos += 1
    lcap = cache["sk"].shape[2]
    kf = cache["sk"].permute(1, 0, 3, 2, 4)  # [T,B,KV,L,hd]
    vf = cache["sv"].permute(1, 0, 3, 2, 4)
    if kv != h:
        kf = kf.repeat_interleave(h // kv, dim=2)
        vf = vf.repeat_interleave(h // kv, dim=2)
    a = backend.decode_attention(
        KVView.dense(kf, vf), q[:, :, :, None, :],
        AttnSpec(i_max=lcap), slot_keys=slot_keys)
    a = a.reshape(t, b, 1, h * hd).to(s.dtype)
    return backend.spiking_linear(_lin_operand(params["wo"], h * hd), a)


def _spiking_decode_ffn_tail(params, s: Tensor, cfg, backend) -> Tensor:
    """The FFN half of a spiking decode block: ``s + LIF(W2 LIF(W1 s))``."""
    if "norm2" not in params:
        return s
    h1 = backend.spiking_linear(
        _lin_operand(params["mlp"]["wi"], s.shape[-1]), s)
    return s + backend.spiking_linear(
        _lin_operand(params["mlp"]["wo"], h1.shape[-1]),
        h1.to(s.dtype)).to(s.dtype)


def _fused_block_weights(params, cfg, d: int):
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    mx = params["mixer"]
    wq = _lin_operand(mx["wq"], d)
    wk = _lin_operand(mx["wk"], d)
    wv = _lin_operand(mx["wv"], d)
    wo = _lin_operand(mx["wo"], h * hd)
    with_mlp = "norm2" in params
    wi = wo2 = None
    if with_mlp:
        wi = _lin_operand(params["mlp"]["wi"], d)
        wo2 = _lin_operand(params["mlp"]["wo"], cfg.d_ff)
    return wq, wk, wv, wo, wi, wo2, with_mlp


def _fused_block_spiking_decode(params, s: Tensor, cache, cfg,
                                slot_keys: Tensor, backend) -> Tensor:
    """One decoder block as one fused-kernel launch over the *pre-scatter*
    cache, then the returned K/V trains scatter in place."""
    wq, wk, wv, wo, wi, wo2, with_mlp = _fused_block_weights(params, cfg,
                                                              s.shape[-1])
    pos = cache["pos"]
    out, k_new, v_new = backend.decode_layer_fused(
        slot_keys, s[:, :, 0, :], KVView.dense(cache["sk"], cache["sv"]),
        pos, wq, wk, wv, wo, wi, wo2, hd=cfg.resolved_head_dim,
        with_mlp=with_mlp)
    scatter_at_pos(cache["sk"], pos, k_new.movedim(0, 1))
    scatter_at_pos(cache["sv"], pos, v_new.movedim(0, 1))
    pos += 1
    return out[:, :, None, :].to(s.dtype)


def _apply_block_spiking_decode(params, s: Tensor, cache, cfg, slot_keys,
                                uid: int, backend,
                                plan: Optional[DecodePlan] = None) -> Tensor:
    """Spiking residual block, decode flavour; block ``uid`` keys its
    draws ``fold_in(slot_key, tag + uid)``."""
    def keys_for(tag):
        return prng.fold_in(slot_keys, tag + uid)

    if plan is not None and plan.fused:
        return _fused_block_spiking_decode(params, s, cache, cfg, keys_for(1),
                                           backend)
    h = _spiking_attention_decode(params["mixer"], s, cache, cfg, keys_for(1),
                                  backend)
    s = s + h.to(s.dtype)
    return _spiking_decode_ffn_tail(params, s, cfg, backend)


def _unembed(params, x: Tensor, cfg) -> Tensor:
    x = L.apply_norm(cfg.norm_type, params["final_norm"], x)
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"]["table"].to(x.dtype).T)
    return L.unembed(params["unembed"], x, cfg)


def _decode_step_spiking(params, cache, tokens: Tensor, cfg, backend,
                         seeds: Tensor, plan: Optional[DecodePlan] = None):
    """tokens ``[B,1]``, seeds ``[B]`` -> (logits ``[B,1,V]``, activity
    ``[B]``): every draw is keyed per slot by ``f(seed, pos)``, and
    ``activity`` counts each slot's residual spike events (input coding
    and after every block)."""
    dt = model_dtype(cfg)
    sqrt_d = torch.tensor(math.sqrt(cfg.d_model), dtype=dt, device=tokens.device)
    x = L.embed(params["embed"], tokens, dt) * sqrt_d
    slot_keys = _slot_base_keys(seeds, _first_pos(cache))
    enc_keys = prng.fold_in(slot_keys, 0)
    s = _slot_rate_encode(enc_keys, x, cfg.spike_T)  # [T,B,1,d] float32

    def slot_events(st):
        return torch.sum(st.to(torch.float32), dim=(0, 2, 3))

    act = slot_events(s)
    for p in range(cfg.num_periods):
        pp = _take(params["periods"], p)
        pc = _take(cache["periods"], p)
        for i in range(cfg.period):
            s = _apply_block_spiking_decode(pp[f"blk{i}"], s, pc[f"blk{i}"],
                                            cfg, slot_keys, p * cfg.period + i,
                                            backend, plan)
            act = act + slot_events(s)
    base_uid = cfg.num_periods * cfg.period
    for i in range(cfg.remainder_layers):
        s = _apply_block_spiking_decode(
            params["remainder"][f"blk{i}"], s, cache["remainder"][f"blk{i}"],
            cfg, slot_keys, base_uid + i, backend, plan)
        act = act + slot_events(s)
    xr = SP.rate_decode(s.to(torch.float32)).to(dt)
    return _unembed(params, xr, cfg), act


def decode_step(params, cache, tokens: Tensor, cfg, *, backend,
                seeds: Optional[Tensor] = None, with_activity: bool = False,
                plan: Optional[DecodePlan] = None):
    """One spiking decode step: tokens ``[B,1]`` -> ``(logits [B,1,V],
    cache)`` (plus ``activity [B]`` with ``with_activity``).  The cache is
    updated in place and returned.  ``seeds [B]`` are the per-slot PRN
    stream ids (zeros by default)."""
    _require_spiking(cfg)
    if seeds is None:
        seeds = torch.zeros(tokens.shape[0], dtype=torch.int64,
                            device=tokens.device)
    logits, act = _decode_step_spiking(params, cache, tokens, cfg, backend,
                                       seeds, plan)
    if with_activity:
        return logits, cache, act
    return logits, cache
