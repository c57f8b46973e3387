"""The spiking LM stack: its full-sequence forward and its decode step.

Twin of the spiking branch of ``repro/models/transformer.py``:

* the forward (lines 198-299, 300-418, 421-455 and 1018): the spiking
  attention, MLP and residual block (``_spiking_attention``,
  ``_spiking_mlp``, ``_apply_block_spiking``), ``_embed_inputs``,
  ``forward`` / ``_forward_spiking``, ``softmax_xent``, ``loss_fn`` and
  ``prefill``.  The reference's key chain is kept exactly: ``split(rng)``
  into the coding and block keys, ``split(k_blocks, n_blocks)``, then
  ``split(key, period)`` a period, ``split(key)`` a block, ``split(k1, 5)``
  in its attention (Q, K, V, the SSA tile, out) and ``split(k2)`` in its
  MLP.  On the reference backend (``"reference"``) the forward and loss
  are differentiable (training, :mod:`repro_torch.train.loop`), and
  ``remat`` recomputes each layer in the backward;
* the decode step (lines 456-528, 536-767 and 770-946): the per-slot
  spike-train KV cache and the block-paged page pool, per-slot PRN keys
  ``f(seed, pos)``, Bernoulli rate coding, the unfused and fused
  attention decodes (dense and paged), the FFN tail, and the unembedding.

A Python loop over layers takes the place of the reference's ``lax.scan``
over the stacked period axis; parameters and caches keep the reference's
stacked layout (``periods`` leaves carry a leading period axis).  The
spiking linears go through ``backend.spiking_linear`` (K1 on the card)
and the SSA tile through ``backend.ssa_attention`` (the keyed K8, reading
the heads in place); ``attention_kind="lif"`` runs
:func:`repro_torch.core.ssa.lif_spiking_attention` instead.  The float
mixers and MoE (``ssd``, ``rglru``), frontends and the float LM stack
raise, naming ROADMAP A12.

Unlike the reference, the decode updates the cache **in place** (scatter of
the new K/V trains and ``pos += 1``): one step never needs two copies of a
cache that is the largest state on the card.  ``decode_step`` returns the
same cache object it was given, ``paged_decode_step`` the same pool.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import aimc_device as AD
from repro_torch import prng
from repro_torch.core import spikes as SP
from repro_torch.core import ssa as SSA
from repro_torch.kernels.plan import AttnSpec, DecodePlan, KVView
from repro_torch.kernels.ref import scatter_at_pos, scatter_into_pages
from repro_torch.models import layers as L

Tensor = torch.Tensor


def model_dtype(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def spiking_decode_enabled(cfg) -> bool:
    return bool(cfg.spiking) and cfg.attention_kind == "ssa"


def paged_decode_supported(cfg) -> bool:
    """Paged spike-train KV caching serves spiking SSA stacks whose every
    mixer is an attention block (recurrent mixers have no position axis
    to page)."""
    return spiking_decode_enabled(cfg) and all(
        m in ("attn", "local") for m in cfg.block_pattern)


_A12 = ("ROADMAP A12 (the non-spiking LM stack: float and recurrent mixers, "
        "MoE, frontends)")


def _require_spiking_stack(cfg) -> None:
    """Raise for what the port's LM stack does not run: a float stack, a
    frontend, MoE, or a mixer other than attention."""
    if not cfg.spiking:
        raise NotImplementedError(
            f"{cfg.name}: the float LM stack is not ported: {_A12}")
    if cfg.frontend != "none" or cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: frontend={cfg.frontend!r}, moe={cfg.is_moe} are "
            f"not ported: {_A12}")
    if any(m not in ("attn", "local") for m in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: mixers {cfg.block_pattern} are not ported: {_A12}")


def _require_spiking(cfg) -> None:
    """The decode step's condition: a spiking stack with SSA attention
    (the reference decodes any other through its float path)."""
    _require_spiking_stack(cfg)
    if not spiking_decode_enabled(cfg):
        raise NotImplementedError(
            f"{cfg.name}: attention_kind={cfg.attention_kind!r} decodes on "
            f"the reference's float path, which is not ported: {_A12}")


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
    _require_spiking_stack(cfg)
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


def device_operands(state: AD.AIMCDeviceState) -> Dict[str, Tensor]:
    """A programmed leaf's digital image as crossbar operands: ``levels_t``
    and ``eff_scale``, leading (period) axes kept."""
    return {"levels": state.levels_t, "scale": state.eff_scale}


def quantize_params(params: Dict[str, Any], cfg, *, keep_state: bool = False
                    ) -> Dict[str, Any]:
    """A copy of ``params`` whose spiking-linear weights are replaced by
    their Table-II operands ``{"levels": int8 [.., d_in, d_out], "scale":
    f32 [.., d_out]}``: float weights quantised, programmed state
    (:class:`repro_torch.aimc_device.AIMCDeviceState`) taken as its
    drifted image and effective scale.  The reference derives them inside
    every jitted step; eager PyTorch would redo it on every call, so the
    scheduler does it once (and again after every drift fold) -- the same
    function of the same leaves.  ``keep_state=True`` quantises the float
    weights and leaves programmed state as it is (what a mesh shards
    before serving)."""
    fan_in = _linear_fan_ins(cfg)

    def block(blk, stacked: bool):
        out = dict(blk)
        for group in ("mixer", "mlp"):
            if group not in blk:
                continue
            g = dict(blk[group])
            for name, w in blk[group].items():
                if isinstance(w, AD.AIMCDeviceState):
                    if not keep_state:
                        g[name] = device_operands(w)
                    continue
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
    if isinstance(tree, AD.AIMCDeviceState):
        return tree.map(lambda x: x[i])
    return tree[i]


def _lin_operand(w, d_in: int):
    """A spiking-linear weight operand: pre-quantised leaves and programmed
    state pass through (a digital backend executes the state's drifted
    image, the reference backend its analog simulation), float arrays
    reshape to the ``[d_in, d_out]`` crossbar view."""
    if isinstance(w, (AD.AIMCDeviceState, dict)):
        return w
    return w.to(torch.float32).reshape(d_in, -1)


# ---------------------------------------------------------------------------
# Spiking forward (train / prefill)
# ---------------------------------------------------------------------------


def _layer_keys(key: Tensor) -> Tensor:
    """A block's seven keys ``[..., 7, 2]`` from its key: ``split(split(key)
    [0], 5)`` (Q, K, V, the SSA tile, attention-out) then ``split(split(key)
    [1])`` (MLP in, MLP out), as the reference's block, attention and MLP
    split them.  The digital backends' linears draw nothing; the reference
    backend's read programmed state's noise from them.  Vectorised over
    leading axes."""
    k12 = prng.split(key)
    return torch.cat([prng.split(k12[..., 0, :], 5),
                      prng.split(k12[..., 1, :])], dim=-2)


def _spiking_attention(params, s: Tensor, cfg, keys: Tensor, backend,
                       tile: Optional[Dict[str, int]] = None) -> Tensor:
    """Attention over spike trains ``s [T,B,S,d]`` (paper Eq. 6): the
    Q/K/V spiking linears, GQA's repeat of the KV heads, the causal SSA
    tile keyed ``keys[3]`` (``attention_kind="lif"``: the LIF attention),
    and the attention-out linear.  The heads are a caller's own (all of
    them on one device, a mesh rank's share otherwise); ``tile`` places
    this call's batch rows in the batch whose comparators are drawn."""
    t, b, n, d = s.shape
    hd = cfg.resolved_head_dim

    def proj(w, i):  # LIF(W s^t): spiking Q/K/V generation (Table I)
        return backend.spiking_linear(_lin_operand(w, d), s, key=keys[i],
                                      part="col")

    q, k, v = (proj(params[w], i) for i, w in enumerate(("wq", "wk", "wv")))
    h, kv = q.shape[-1] // hd, k.shape[-1] // hd
    if kv != h:  # GQA: repeat the KV spike heads across their group
        k, v = (x.view(t, b, n, kv, hd).repeat_interleave(h // kv, dim=3)
                .view(t, b, n, h * hd) for x in (k, v))
    qh, kh, vh = SP.heads(q, h), SP.heads(k, h), SP.heads(v, h)
    if cfg.attention_kind == "lif":
        a = SSA.lif_spiking_attention(qh.to(s.dtype), kh.to(s.dtype),
                                      vh.to(s.dtype), causal=True)
    else:
        a = backend.ssa_attention(keys[3], qh, kh, vh, causal=True,
                                  **(tile or {}))
    a = SP.unheads(a)
    # LIF on the output projection (spiking neuron tile semantics)
    return backend.spiking_linear(_lin_operand(params["wo"], a.shape[-1]), a,
                                  key=keys[4], part="row")


def _spiking_mlp(params, s: Tensor, keys: Tensor, backend) -> Tensor:
    """``LIF(W2 LIF(W1 s^t))``: Table I's feed-forward row, keyed
    ``keys[5]``, ``keys[6]``."""
    h = backend.spiking_linear(_lin_operand(params["wi"], s.shape[-1]), s,
                               key=keys[5], part="col")
    return backend.spiking_linear(_lin_operand(params["wo"], h.shape[-1]), h,
                                  key=keys[6], part="row")


def _block_spiking(params, s: Tensor, cfg, keys: Tensor, backend,
                   tile: Optional[Dict[str, int]] = None) -> Tensor:
    """One spiking residual block over ``s [T,B,S,d]`` given its seven
    keys (:func:`_layer_keys`): residuals add spike trains directly (Table
    I: no inter-layer normalisation)."""
    s = s + _spiking_attention(params["mixer"], s, cfg, keys, backend,
                               tile).to(s.dtype)
    if "norm2" in params:
        s = s + _spiking_mlp(params["mlp"], s, keys, backend).to(s.dtype)
    return s


def _apply_block_spiking(params, s: Tensor, cfg, mixer: str, key: Tensor,
                         backend, tile: Optional[Dict[str, int]] = None
                         ) -> Tensor:
    """The reference's spiking residual block (``mixer`` ``"attn"`` or
    ``"local"``: the spiking attention sees the whole causal prefix in
    both, as in the reference), keyed by the block's ``key``.  Returns the
    new spike trains (no MoE: no auxiliary loss)."""
    if mixer not in ("attn", "local"):
        raise NotImplementedError(f"mixer {mixer!r} is not ported: {_A12}")
    return _block_spiking(params, s, cfg, _layer_keys(key), backend, tile)


def _embed_inputs(params, batch: Dict[str, Tensor], cfg) -> Tensor:
    """Token embedding times ``sqrt(d_model)`` in the model dtype."""
    dt = model_dtype(cfg)
    x = L.embed(params["embed"], batch["tokens"], dt)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt, device=x.device)


def _block_keys(k_blocks: Tensor, cfg) -> Tensor:
    """Every layer's key in layer order, ``[L, 2]``: ``split(k_blocks,
    n_blocks)``, then ``split(key, period)`` a period and ``split(key,
    remainder_layers)`` for the remainder, as the reference's scan draws
    them."""
    n_blocks = cfg.num_periods + (1 if cfg.remainder_layers else 0)
    keys = prng.split(k_blocks, max(n_blocks, 1))
    out = []
    if cfg.num_periods > 0:
        out.append(prng.split(keys[:cfg.num_periods], cfg.period)
                   .reshape(-1, 2))
    if cfg.remainder_layers:
        out.append(prng.split(keys[-1], cfg.remainder_layers))
    return torch.cat(out)


def _remat_block(remat: str, backend):
    """``remat`` as a wrapper of one layer: ``"none"`` runs it as it is;
    ``"block"`` and ``"full"`` recompute it in the backward
    (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
    activations, where the reference wraps its period in
    ``jax.checkpoint``.  Every draw is keyed, so the recomputation is
    exact.  Where autograd records nothing, or the backend is not
    differentiable, nothing is kept anyway."""
    if remat not in ("none", "block", "full"):
        raise ValueError(f"remat must be none|block|full, got {remat!r}")
    if (remat == "none" or not torch.is_grad_enabled()
            or not getattr(backend, "differentiable", False)):
        return _block_spiking

    def run(*args):
        return torch.utils.checkpoint.checkpoint(_block_spiking, *args,
                                                 use_reentrant=False)

    return run


def spiking_features(params, batch: Dict[str, Tensor], cfg, *, rng: Tensor,
                     backend, rows: Optional[Tuple[int, int]] = None,
                     remat: str = "none") -> Tensor:
    """The spiking forward up to the unembed: embed, rate coding, every
    block, rate decoding -> ``[B, S, d]`` in the model dtype.  ``rows =
    (b0, n)`` runs batch rows ``b0 .. b0+n`` only (a mesh rank's share):
    the coding draws at the whole batch's shape and the SSA tiles at the
    whole batch's grid, so the rows equal those of the whole batch.
    ``remat`` (:func:`_remat_block`) trades a layer's kept activations for
    its recomputation in training.

    The key chain runs on the host (a few tiny threefry calls, not a few
    hundred kernel launches); the keys move to the card once."""
    _require_spiking_stack(cfg)
    if rng is None:
        raise ValueError("the spiking forward needs an rng for Bernoulli "
                         "coding")
    x = _embed_inputs(params, batch, cfg)
    dev = x.device
    k_enc, k_blocks = prng.split(rng.cpu())
    s = SP.rate_encode(k_enc.to(dev), torch.sigmoid(x), cfg.spike_T)
    tile = None
    if rows is not None:
        b0, n = rows
        tile = {"b0": b0, "batch": s.shape[1]}
        s = s[:, b0:b0 + n]
    lkeys = _layer_keys(_block_keys(k_blocks, cfg)).to(dev)
    block = _remat_block(remat, backend)
    layer = 0
    for p in range(cfg.num_periods):
        pp = _take(params["periods"], p)
        for i in range(cfg.period):
            s = block(pp[f"blk{i}"], s, cfg, lkeys[layer], backend, tile)
            layer += 1
    for i in range(cfg.remainder_layers):
        s = block(params["remainder"][f"blk{i}"], s, cfg, lkeys[layer],
                  backend, tile)
        layer += 1
    # rate-decode the stream (paper: loss on the time-averaged output)
    return SP.rate_decode(s.to(torch.float32)).to(model_dtype(cfg))


def _forward_spiking(params, batch, cfg, *, rng, backend,
                     remat: str = "none", rows=None):
    """Spiking forward: rate-encode, spiking blocks over T, rate-decode,
    unembed -> ``(logits [B,S,V], aux 0)`` (``rows``: those rows only)."""
    x = spiking_features(params, batch, cfg, rng=rng, backend=backend,
                         remat=remat, rows=rows)
    return _unembed(params, x, cfg), torch.zeros((), device=x.device)


def forward(params, batch: Dict[str, Tensor], cfg, *,
            rng: Optional[Tensor] = None, backend=None, remat: str = "block",
            rows: Optional[Tuple[int, int]] = None) -> Tuple[Tensor, Tensor]:
    """Train/prefill forward: ``batch["tokens"] [B,S]`` -> ``(logits
    [B,S,V], aux)``; ``aux`` (MoE's load-balancing loss) is zero.
    ``backend`` defaults to the CUDA one (:func:`repro_torch.engine.
    get_backend`); the reference backend (``"reference"``) is the one
    autograd trains through.  ``remat`` applies where autograd records
    (:func:`_remat_block`).  ``rows = (b0, n)``: the logits of batch rows
    ``b0 .. b0+n`` only, equal to those rows of the whole batch's (a data
    rank's share, :func:`spiking_features`)."""
    from repro_torch.engine import get_backend

    return _forward_spiking(params, batch, cfg, rng=rng,
                            backend=get_backend(backend), remat=remat,
                            rows=rows)


def softmax_xent(logits: Tensor, targets: Tensor,
                 mask: Optional[Tensor] = None) -> Tensor:
    """Mean cross-entropy in f32 (over ``mask``'s weight where given)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.take_along_dim(lf, targets[..., None].long(), dim=-1)[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def loss_fn(params, batch, cfg, *, rng: Optional[Tensor] = None,
            aux_weight: float = 0.01, backend=None, remat: str = "block",
            rows: Optional[Tuple[int, int]] = None
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Next-token loss of ``batch["tokens"] [B, S+1]`` (inputs all but the
    last, targets all but the first; ``batch["mask"]`` optional) ->
    ``(loss, {"xent", "moe_aux"})``; differentiable on the reference
    backend.  ``rows = (b0, n)``: the mean over those rows of the batch
    only, drawn as the whole batch draws them (a data rank's share)."""
    _require_spiking_stack(cfg)
    logits, aux = forward(params, {"tokens": batch["tokens"][:, :-1]}, cfg,
                          rng=rng, backend=backend, remat=remat, rows=rows)
    if rows is not None:
        batch = {k: v[rows[0]:rows[0] + rows[1]] for k, v in batch.items()}
    xent = softmax_xent(logits, batch["tokens"][:, 1:], batch.get("mask"))
    return xent + aux_weight * aux, {"xent": xent, "moe_aux": aux}


def prefill(params, batch, cfg, *, rng: Optional[Tensor] = None,
            backend=None):
    """Prefill forward returning ``(logits, aux)`` (the cache is produced
    by the decode over the prompt in serving).  The reference's
    ``prefill`` passes no rng to ``forward``, so a spiking config fails
    its assertion there; this one takes the rng and the backend the
    spiking forward needs."""
    return forward(params, batch, cfg, rng=rng, backend=backend,
                   remat="none")


# ---------------------------------------------------------------------------
# Spiking KV cache
# ---------------------------------------------------------------------------


def _per_block(cfg, blk) -> Dict[str, Any]:
    """``blk(lead)`` for every attention block: stacked ``periods`` leaves
    get a leading period axis, ``remainder`` leaves none."""
    out: Dict[str, Any] = {}
    if cfg.num_periods > 0:
        out["periods"] = {f"blk{i}": blk((cfg.num_periods,))
                          for i in range(cfg.period)}
    if cfg.remainder_layers:
        out["remainder"] = {f"blk{i}": blk(())
                            for i in range(cfg.remainder_layers)}
    return out


def init_cache(cfg, batch: int, seq_len: int, device,
               kv_heads: Optional[int] = None) -> Dict[str, Any]:
    """Zero per-slot spike-train caches: ``sk``/``sv [B, T, L, KV, hd]``
    uint8 and ``pos [B]`` int32 per attention block (stacked periods get a
    leading period axis).  Positions past ``pos`` hold zero spikes, which
    masks them out of the SSA comparators.  ``kv_heads`` (default: all)
    is the KV heads a mesh rank caches."""
    _require_spiking(cfg)
    kv, hd = kv_heads or cfg.num_kv_heads, cfg.resolved_head_dim

    def blk(lead):
        shape = lead + (batch, cfg.spike_T, seq_len, kv, hd)
        return {"sk": torch.zeros(shape, dtype=torch.uint8, device=device),
                "sv": torch.zeros(shape, dtype=torch.uint8, device=device),
                "pos": torch.zeros(lead + (batch,), dtype=torch.int32,
                                   device=device)}

    return _per_block(cfg, blk)


def init_paged_pool(cfg, n_pages: int, page_len: int, device,
                    kv_heads: Optional[int] = None) -> Dict[str, Any]:
    """An all-zero page pool: ``kp``/``vp [n_pages, T, KV, page_len, hd]``
    uint8 per attention block, no slot axis (slots address pages through
    a page table).  Page 0 is the permanently zero null page (unallocated
    table entries read as zero spikes), page 1 the trash page idle slots
    write into (never in a table).  ``kv_heads`` (default: all) is the KV
    heads a mesh rank holds."""
    _require_spiking(cfg)
    kv, hd = kv_heads or cfg.num_kv_heads, cfg.resolved_head_dim

    def blk(lead):
        shape = lead + (n_pages, cfg.spike_T, kv, page_len, hd)
        return {"kp": torch.zeros(shape, dtype=torch.uint8, device=device),
                "vp": torch.zeros(shape, dtype=torch.uint8, device=device)}

    return _per_block(cfg, blk)


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


def _qkv_spikes(params, s: Tensor, cfg, backend):
    """The Q/K/V spiking linears of one token: ``s [T,B,1,d]`` ->
    ``q [T,B,H,hd]``, ``k_new``/``v_new [T,B,KV,hd]``."""
    t, b, _, d = s.shape
    hd = cfg.resolved_head_dim

    def proj(w):
        out = backend.spiking_linear(_lin_operand(w, d), s, part="col")
        return out.reshape(t, b, -1, hd)

    return proj(params["wq"]), proj(params["wk"]), proj(params["wv"])


def _attention_out(params, view: KVView, q: Tensor, i_max: int, s: Tensor,
                   cfg, slot_keys: Tensor, backend) -> Tensor:
    """One query row over ``view``, then the attention-out linear (its
    input rows are this caller's heads: all of them on one device, a
    rank's own on a mesh)."""
    t, b, _, _ = s.shape
    a = backend.decode_attention(view, q[:, :, :, None, :],
                                 AttnSpec(i_max=i_max), slot_keys=slot_keys)
    a = a.reshape(t, b, 1, -1).to(s.dtype)
    return backend.spiking_linear(_lin_operand(params["wo"], a.shape[-1]), a,
                                  part="row")


def _spiking_attention_decode(params, s: Tensor, cache, cfg, slot_keys: Tensor,
                              backend) -> Tensor:
    """Unfused one-token SSA decode: Q/K/V spiking linears, scatter of the
    new K/V trains at ``pos`` (in place), one query row over the whole
    cache, attention-out.  ``s [T,B,1,d]``."""
    q, k_new, v_new = _qkv_spikes(params, s, cfg, backend)
    h, kv = q.shape[2], k_new.shape[2]  # a mesh rank's own heads
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
    # rows at and past each slot's (advanced) pos are zero: a kernel may
    # stop there
    return _attention_out(params, KVView.dense(kf, vf, pos), q, lcap, s, cfg,
                          slot_keys, backend)


def _spiking_attention_decode_paged(params, s: Tensor, blk_pool, cfg,
                                    page_table: Tensor, pos: Tensor,
                                    write_pids: Tensor, slot_keys: Tensor,
                                    backend) -> Tensor:
    """Unfused one-token SSA decode over the page pool: the new K/V trains
    scatter (in place) into each slot's designated physical page
    ``write_pids [B]`` at ``pos % page_len`` (the trash page for idle
    slots), then the query attends through the page table.  The logical
    capacity ``MP * page_len`` is the comparator range, as in the dense
    layout, so both give the same spikes for the same logical content."""
    q, k_new, v_new = _qkv_spikes(params, s, cfg, backend)
    scatter_into_pages(blk_pool["kp"], write_pids, pos, k_new.movedim(0, 1))
    scatter_into_pages(blk_pool["vp"], write_pids, pos, v_new.movedim(0, 1))
    i_max = page_table.shape[1] * blk_pool["kp"].shape[3]
    # rows after each slot's write position are zero: a kernel may stop
    # there
    view = KVView.from_pool(blk_pool["kp"], blk_pool["vp"], page_table, pos)
    return _attention_out(params, view, q, i_max, s, cfg, slot_keys, backend)


def _spiking_decode_ffn_tail(params, s: Tensor, cfg, backend) -> Tensor:
    """The FFN half of a spiking decode block: ``s + LIF(W2 LIF(W1 s))``."""
    if "norm2" not in params:
        return s
    h1 = backend.spiking_linear(
        _lin_operand(params["mlp"]["wi"], s.shape[-1]), s, part="col")
    return s + backend.spiking_linear(
        _lin_operand(params["mlp"]["wo"], h1.shape[-1]),
        h1.to(s.dtype), part="row").to(s.dtype)


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


def _fused_block_spiking_decode_paged(params, s: Tensor, blk_pool, cfg,
                                      page_table: Tensor, pos: Tensor,
                                      write_pids: Tensor, slot_keys: Tensor,
                                      backend) -> Tensor:
    """One decoder block as one fused-kernel launch over the *pre-scatter*
    page pool, then the returned K/V trains scatter (in place) into each
    slot's write page."""
    wq, wk, wv, wo, wi, wo2, with_mlp = _fused_block_weights(params, cfg,
                                                              s.shape[-1])
    out, k_new, v_new = backend.decode_layer_fused(
        slot_keys, s[:, :, 0, :],
        KVView.from_pool(blk_pool["kp"], blk_pool["vp"], page_table), pos,
        wq, wk, wv, wo, wi, wo2, hd=cfg.resolved_head_dim, with_mlp=with_mlp,
        write_pids=write_pids)
    scatter_into_pages(blk_pool["kp"], write_pids, pos, k_new.movedim(0, 1))
    scatter_into_pages(blk_pool["vp"], write_pids, pos, v_new.movedim(0, 1))
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


def _apply_block_spiking_decode_paged(params, s: Tensor, blk_pool, cfg,
                                      page_table: Tensor, pos: Tensor,
                                      write_pids: Tensor, slot_keys, uid: int,
                                      backend,
                                      plan: Optional[DecodePlan] = None
                                      ) -> Tensor:
    """Spiking residual block over the page pool (decode flavour); the
    same draws as :func:`_apply_block_spiking_decode`."""
    keys = prng.fold_in(slot_keys, 1 + uid)
    if plan is not None and plan.fused:
        return _fused_block_spiking_decode_paged(
            params, s, blk_pool, cfg, page_table, pos, write_pids, keys,
            backend)
    h = _spiking_attention_decode_paged(params["mixer"], s, blk_pool, cfg,
                                        page_table, pos, write_pids, keys,
                                        backend)
    s = s + h.to(s.dtype)
    return _spiking_decode_ffn_tail(params, s, cfg, backend)


def _unembed(params, x: Tensor, cfg) -> Tensor:
    x = L.apply_norm(cfg.norm_type, params["final_norm"], x)
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"]["table"].to(x.dtype).T)
    return L.unembed(params["unembed"], x, cfg)


def _decode_stack(params, tree, tokens: Tensor, cfg, slot_keys: Tensor,
                  block):
    """The spiking decode around the blocks: embed, per-slot rate coding,
    ``s = block(blk_params, s, blk_tree, uid)`` for every block in layer
    order (``tree`` is the cache or pool, indexed like the params), rate
    decoding and the unembed.  tokens ``[B,1]`` -> (logits ``[B,1,V]``,
    activity ``[B]``): ``activity`` counts each slot's residual spike
    events (input coding and after every block)."""
    dt = model_dtype(cfg)
    sqrt_d = torch.tensor(math.sqrt(cfg.d_model), dtype=dt, device=tokens.device)
    x = L.embed(params["embed"], tokens, dt) * sqrt_d
    enc_keys = prng.fold_in(slot_keys, 0)
    s = _slot_rate_encode(enc_keys, x, cfg.spike_T)  # [T,B,1,d] float32

    def slot_events(st):
        return torch.sum(st.to(torch.float32), dim=(0, 2, 3))

    act = slot_events(s)
    for p in range(cfg.num_periods):
        pp = _take(params["periods"], p)
        pt = _take(tree["periods"], p)
        for i in range(cfg.period):
            s = block(pp[f"blk{i}"], s, pt[f"blk{i}"], p * cfg.period + i)
            act = act + slot_events(s)
    base_uid = cfg.num_periods * cfg.period
    for i in range(cfg.remainder_layers):
        s = block(params["remainder"][f"blk{i}"], s,
                  tree["remainder"][f"blk{i}"], base_uid + i)
        act = act + slot_events(s)
    xr = SP.rate_decode(s.to(torch.float32)).to(dt)
    return _unembed(params, xr, cfg), act


def _decode_step_spiking(params, cache, tokens: Tensor, cfg, backend,
                         seeds: Tensor, plan: Optional[DecodePlan] = None):
    """tokens ``[B,1]``, seeds ``[B]`` -> (logits ``[B,1,V]``, activity
    ``[B]``): every draw is keyed per slot by ``f(seed, pos)``."""
    slot_keys = _slot_base_keys(seeds, _first_pos(cache))

    def block(bp, s, bc, uid):
        return _apply_block_spiking_decode(bp, s, bc, cfg, slot_keys, uid,
                                           backend, plan)

    return _decode_stack(params, cache, tokens, cfg, slot_keys, block)


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


def paged_decode_step(params, pool, page_table: Tensor, tokens: Tensor,
                      pos: Tensor, seeds: Tensor, write_pids: Tensor, cfg, *,
                      backend, plan: Optional[DecodePlan] = None):
    """One spiking decode step over the block-paged pool.

    tokens ``[B,1]``, pos ``[B]`` (each slot's logical write position),
    seeds ``[B]`` (the PRN stream id this step: the request seed in
    decode, the *content key* of the position in chunked prefill),
    write_pids ``[B]`` (each slot's private physical page for block ``pos
    // page_len``; the trash page for idle slots) -> ``(logits [B,1,V],
    pool, activity [B])``.  The pool is updated in place and returned.

    Every draw is keyed ``f(seed, pos, ...)`` as in :func:`decode_step`,
    and the content reachable through a slot's table equals its dense
    cache, so paged serving gives dense serving's tokens while prompt
    prefixes shared between requests resolve to the same physical pages."""
    if not paged_decode_supported(cfg):
        raise ValueError(f"{cfg.name}: paged decode needs a spiking SSA "
                         "stack of attention blocks")
    slot_keys = _slot_base_keys(seeds, pos)

    def block(bp, s, bpool, uid):
        return _apply_block_spiking_decode_paged(
            bp, s, bpool, cfg, page_table, pos, write_pids, slot_keys, uid,
            backend, plan)

    logits, act = _decode_stack(params, pool, tokens, cfg, slot_keys, block)
    return logits, pool, act
