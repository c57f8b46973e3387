"""The generic LM stack: float and spiking, full-sequence forward and
decode step.

Twin of ``repro/models/transformer.py``, on one device or a rank of a
mesh (a MoE block routes over the model group through its ``pctx``; on a
training mesh, :func:`repro_torch.parallel.sharding.make_pctx`'s, each
block's ZeRO-3 pieces are gathered over ``data`` just before it runs,
the attention, MLP, SSD, RG-LRU and vocabulary run on the rank's
``model`` cut, the batch on its rows, and the loss is the global mean):

* the float stack (lines 53-191, 300-373, 421-453, 483-533, 949-1025):
  dense and local:global attention, Mamba-2's SSD, RecurrentGemma's
  RG-LRU and the frontend backbones (precomputed embeddings through a
  projection), MoE blocks (:mod:`repro_torch.models.moe`, ``moe_impl``
  ``"dense"`` or the sort-based ``"ep_a2a"``; arctic's dense residual MLP
  beside the experts; the load-balancing loss summed over the blocks),
  tied embeddings, the forward with ``remat``, the loss, the per-slot
  decode caches (``{k, v, pos}``, a ring buffer for a windowed
  layer; ``{ssd, conv_x, conv_bc, pos}``; ``{h, conv, pos}``) and the
  float decode step, which also decodes a spiking stack whose attention
  is not SSA (``attention_kind="lif"``), as the reference's does.  Its
  products are plain ``torch.matmul``/``einsum`` (the reference's are
  plain einsums outside any Pallas kernel).  ``init_params`` draws a float
  stack's weights as the reference's ``init_params(PRNGKey(seed), cfg)``
  does, through the threefry twin on the device: the same values, up to
  ``erfinv``'s last bits;
* the spiking forward (lines 198-299, 300-418, 421-455 and 1018): the
  spiking attention, MLP and residual block (``_spiking_attention``,
  ``_spiking_mlp``, ``_apply_block_spiking``; SSD and RG-LRU mixers on the
  rate interface), ``_embed_inputs``, ``forward`` / ``_forward_spiking``,
  ``softmax_xent``, ``loss_fn`` and ``prefill``; a MoE block's FFN on the
  rate interface (decode the rate, ``moe_dense``, re-encode its sigmoid
  keyed by the block's second key; the dense MLP ignored, as in the
  reference).  The reference's key chain is kept exactly: ``split(rng)``
  into the coding and block keys, ``split(k_blocks, n_blocks)``, then
  ``split(key, period)`` a period, ``split(key)`` a block, ``split(k1,
  5)`` in its attention (Q, K, V, the SSA tile, out) and ``split(k2)`` in
  its MLP.  On the reference backend
  (``"reference"``) the forward and loss are differentiable (training,
  :mod:`repro_torch.train.loop`), and ``remat`` recomputes each layer in
  the backward;
* the spiking decode step (lines 456-528, 536-767 and 770-946): the
  per-slot spike-train KV cache and the block-paged page pool, per-slot
  PRN keys ``f(seed, pos)``, Bernoulli rate coding, the unfused and fused
  attention decodes (dense and paged), the FFN tail (a MoE block's on the
  rate interface, keyed ``fold_in(slot_key, 200003 + layer)``), and the
  unembedding.

A Python loop over layers takes the place of the reference's ``lax.scan``
over the stacked period axis; parameters and caches keep the reference's
stacked layout (``periods`` leaves carry a leading period axis).  The
spiking linears go through ``backend.spiking_linear`` (K1 on the card)
and the SSA tile through ``backend.ssa_attention`` (the keyed K8, reading
the heads in place); ``attention_kind="lif"`` runs
:func:`repro_torch.core.ssa.lif_spiking_attention` instead.

Unlike the reference, the decode updates the cache **in place** (scatter of
the new K/V rows and ``pos += 1``, the recurrent states overwritten): one
step never needs two copies of a cache that is the largest state on the
card.  ``decode_step`` returns the same cache object it was given,
``paged_decode_step`` the same pool.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import aimc_device as AD
from repro_torch import prng
from repro_torch.core import spikes as SP
from repro_torch.core import ssa as SSA
from repro_torch.kernels.plan import AttnSpec, DecodePlan, KVView
from repro_torch.kernels.ref import scatter_at_pos, scatter_into_pages
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S

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


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _attention_schema(cfg) -> Dict[str, Any]:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    s = {"wq": ((d, h, hd), "normal"), "wk": ((d, kv, hd), "normal"),
         "wv": ((d, kv, hd), "normal"), "wo": ((h, hd, d), "normal")}
    if cfg.qkv_bias:
        s.update(bq=((h, hd), "zeros"), bk=((kv, hd), "zeros"),
                 bv=((kv, hd), "zeros"))
    return s


def _block_schema(cfg, mixer: str) -> Dict[str, Any]:
    """One block's leaves as ``(shape, init)``, ``init`` one of
    ``normal``, ``zeros``, ``ones`` (the reference's ``block_schema``)."""
    d = cfg.d_model
    s: Dict[str, Any] = {"norm1": {"scale": ((d,), "ones")}}
    if mixer in ("attn", "local"):
        s["mixer"] = _attention_schema(cfg)
    elif mixer == "ssd":
        s["mixer"] = S.ssd_schema(cfg)
    elif mixer == "rglru":
        s["mixer"] = R.rglru_schema(cfg)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    if cfg.d_ff > 0:
        s["norm2"] = {"scale": ((d,), "ones")}
        if cfg.is_moe:
            s["moe"] = M.moe_schema(cfg)
        ff = cfg.moe_dense_ff if cfg.is_moe else cfg.d_ff
        if ff > 0:
            s["mlp"] = {"wi": ((d, ff), "normal"), "wo": ((ff, d), "normal")}
            if cfg.gated_mlp:
                s["mlp"]["wg"] = ((d, ff), "normal")
    return s


def _map_schema(f, tree):
    return ({k: _map_schema(f, v) for k, v in tree.items()}
            if isinstance(tree, dict) else f(tree))


def _model_schema(cfg) -> Dict[str, Any]:
    """The reference's ``model_schema``: stacked ``periods`` (a leading
    period axis), the unrolled ``remainder``, the unembedding unless tied,
    a frontend's projection."""
    s: Dict[str, Any] = {
        "embed": {"table": ((cfg.vocab_size, cfg.d_model), "normal")},
        "final_norm": {"scale": ((cfg.d_model,), "ones")},
    }
    if cfg.num_periods > 0:
        period = {f"blk{i}": _block_schema(cfg, m)
                  for i, m in enumerate(cfg.block_pattern)}
        s["periods"] = _map_schema(
            lambda leaf: ((cfg.num_periods,) + leaf[0], leaf[1]), period)
    if cfg.remainder_layers:
        s["remainder"] = {f"blk{i}": _block_schema(cfg, cfg.block_pattern[i])
                          for i in range(cfg.remainder_layers)}
    if not cfg.tie_embeddings:
        s["unembed"] = {"w": ((cfg.d_model, cfg.vocab_size), "normal")}
    if cfg.frontend != "none":
        s["frontend"] = {"proj": ((cfg.frontend_dim, cfg.d_model), "normal")}
    return s


def _model_shapes(cfg) -> Dict[str, Any]:
    """Leaf shapes of the reference's parameter tree (stacked periods)."""
    return _map_schema(lambda leaf: leaf[0], _model_schema(cfg))


def _schema_leaves(schema, path=()):
    """``(path, shape, init)`` in the reference's leaf order (sorted keys
    at every level, as ``jax.tree`` flattens a dict)."""
    for k in sorted(schema):
        v = schema[k]
        if isinstance(v, dict):
            yield from _schema_leaves(v, path + (k,))
        else:
            yield path + (k,), v[0], v[1]


def _set_path(tree: Dict[str, Any], path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


# the largest piece of one normal draw made at once: its index words and
# threefry temporaries take about 48 bytes an element
_DRAW_CHUNK = 1 << 25


def _reference_normal(key: Tensor, shape, std: float, dtype, device,
                      blocks: Optional[Dict[int, Tuple[int, int]]] = None
                      ) -> Tensor:
    """``(jax.random.normal(key, shape) * std).astype(dtype)``, drawn on
    ``device`` a bounded piece at a time (a draw's words depend on their
    flat index alone), so no host or device buffer holds more than one
    piece of the draw's temporaries.  ``blocks = {axis: (start, n)}``:
    only indices ``start .. start+n`` of each such axis, drawn where they
    lie in the whole draw."""
    shape = tuple(shape)
    nd = len(shape)
    starts, sizes = [0] * nd, list(shape)
    for ax, (start, n) in (blocks or {}).items():
        starts[ax % nd], sizes[ax % nd] = start, n
    out = torch.empty(sizes, dtype=dtype, device=device)
    flat = out.view(-1)
    total = flat.numel()
    for a in range(0, total, _DRAW_CHUNK):
        idx = torch.arange(a, min(a + _DRAW_CHUNK, total), dtype=torch.int64,
                           device=device)
        if blocks:  # the block's flat positions -> the whole draw's
            rem, whole, stride = idx, torch.zeros_like(idx), 1
            for ax in range(nd - 1, -1, -1):
                whole += (starts[ax] + rem % sizes[ax]) * stride
                rem = rem // sizes[ax]
                stride *= shape[ax]
            idx = whole
        flat[a:a + idx.numel()] = (prng.normal_at(key, idx) * std).to(dtype)
    return out


def _blocks(where, shape) -> Optional[Dict[int, Tuple[int, int]]]:
    """A training :class:`repro_torch.parallel.sharding.Placement`'s cut
    of a leaf of ``shape`` as :func:`_reference_normal`'s ``blocks``."""
    if where is None or not where.spec:
        return None
    out = {}
    for ax, name in enumerate(where.spec):
        size = where.axis_size(name)
        if size > 1:
            n = shape[ax] // size
            out[ax] = (where.coords[0 if name == "data" else 1] * n, n)
    return out or None


def _init_like_reference(cfg, seed: int, device,
                         experts: Optional[Tuple[int, int]] = None,
                         placement=None) -> Dict[str, Any]:
    """The reference's ``init_tree``: one key per leaf from
    ``split(PRNGKey(seed), n_leaves)`` in its leaf order; a normal leaf
    is ``normal * 1/sqrt(fan)``, the fan its (per-layer) first axis.
    ``experts = (index, model)``: each MoE leaf holds only the block of
    experts rank ``index`` of a ``model`` group holds, at its values in
    the whole draw; ``placement`` (a training rank's): each leaf only the
    rank's cut, likewise."""
    dtype = model_dtype(cfg)
    leaves = list(_schema_leaves(_model_schema(cfg)))
    keys = prng.split(prng.PRNGKey(seed), len(leaves)).to(device)
    out: Dict[str, Any] = {}
    for (path, shape, init), key in zip(leaves, keys):
        where = placement
        for k in path:
            where = where[k] if isinstance(where, dict) else where
        blocks = _blocks(where, shape)
        if init == "normal":
            stacked = path[0] == "periods"
            fan_in = shape[1] if stacked and len(shape) > 2 else None
            fan = fan_in or (shape[0] if len(shape) > 1 else max(shape[0], 1))
            if experts is not None and "moe" in path and path[-1] != "router":
                n = M.expert_block(cfg.num_experts, experts[1])
                blocks = {-3: (experts[0] * n, n)}
            w = _reference_normal(key, shape, 1.0 / math.sqrt(fan), dtype,
                                  device, blocks)
        else:
            if blocks:
                shape = tuple(blocks.get(a, (0, n))[1]
                              for a, n in enumerate(shape))
            fill = torch.zeros if init == "zeros" else torch.ones
            w = fill(shape, dtype=dtype, device=device)
        _set_path(out, path, w)
    return out


def _init_spiking(cfg, seed: int, device) -> Dict[str, Any]:
    """A spiking stack's weights: normal with std ``1/sqrt(fan_in)``, the
    fan-in being every axis of one layer's matrix but the last (``d*h``
    for a Q projection, ``h*hd`` for the attention out-projection; an
    expert's own input axis for a MoE leaf), drawn
    in the reference's leaf order from a CPU ``torch.Generator``, so the
    values do not depend on the device; norm scales one, biases zero."""
    gen = torch.Generator().manual_seed(seed)
    dtype = model_dtype(cfg)
    out: Dict[str, Any] = {}
    for path, shape, init in _schema_leaves(_model_schema(cfg)):
        if init == "normal":
            per_layer = shape[1:] if path[0] == "periods" else shape
            fan = (per_layer[-2] if "moe" in path
                   else math.prod(per_layer[:-1]))
            w = torch.randn(shape, generator=gen, dtype=torch.float32)
            w = (w / math.sqrt(fan)).to(dtype=dtype, device=device)
        else:
            fill = torch.zeros if init == "zeros" else torch.ones
            w = fill(shape, dtype=dtype, device=device)
        _set_path(out, path, w)
    return out


def init_params(cfg, seed: int, device,
                experts: Optional[Tuple[int, int]] = None,
                placement=None) -> Dict[str, Any]:
    """Random weights from ``seed`` on ``device``.  A float stack's are the
    reference's ``init_params(PRNGKey(seed), cfg)`` (drawn on the device
    through the threefry twin, equal up to ``erfinv``'s last bits; with
    ``experts = (index, model)`` only a serving mesh rank's block of each
    MoE leaf, with a training ``placement`` only the rank's cut of each
    leaf); a spiking stack's come from a CPU ``torch.Generator``
    (:func:`_init_spiking`, cut after the whole draw)."""
    if cfg.spiking:
        params = _init_spiking(cfg, seed, device)
        if placement is None:
            return params
        from repro_torch.checkpoint.manager import map_with_placement

        return map_with_placement(
            lambda x, where, field: x if where.whole
            else where.piece(x, field).contiguous(), params, placement)
    return _init_like_reference(cfg, seed, device, experts, placement)


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
        # a MoE block's FFN runs on the rate interface: its dense MLP is
        # not a spiking linear (the reference's spiking blocks ignore it)
        for group in ("mixer",) if "moe" in blk else ("mixer", "mlp"):
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
    """A block's nine keys ``[..., 9, 2]`` from its key: ``split(split(key)
    [0], 5)`` (Q, K, V, the SSA tile, attention-out), ``split(split(key)
    [1])`` (MLP in, MLP out), and ``split(key)[0]`` and ``[1]`` themselves
    (a recurrent mixer's and a MoE FFN's rate coding), as the reference's
    block, attention and MLP split them.  The digital backends' linears
    draw nothing; the reference backend's read programmed state's noise
    from them.  Vectorised over leading axes."""
    k12 = prng.split(key)
    return torch.cat([prng.split(k12[..., 0, :], 5),
                      prng.split(k12[..., 1, :]), k12], dim=-2)


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
                                      part="col", group="mixer")

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
                                  key=keys[4], part="row", group="mixer")


def _spiking_mlp(params, s: Tensor, keys: Tensor, backend) -> Tensor:
    """``LIF(W2 LIF(W1 s^t))``: Table I's feed-forward row, keyed
    ``keys[5]``, ``keys[6]``."""
    h = backend.spiking_linear(_lin_operand(params["wi"], s.shape[-1]), s,
                               key=keys[5], part="col", group="mlp")
    return backend.spiking_linear(_lin_operand(params["wo"], h.shape[-1]), h,
                                  key=keys[6], part="row", group="mlp")


# the attention-free mixers: (train/prefill, one-token decode)
_RECURRENT = {"ssd": (S.ssd_mixer, S.ssd_decode),
              "rglru": (R.rglru_mixer, R.rglru_decode)}


def _block_spiking(params, s: Tensor, cfg, keys: Tensor, backend,
                   tile: Optional[Dict[str, int]] = None,
                   mixer: str = "attn", pctx: Optional[M.ParallelCtx] = None
                   ) -> Tuple[Tensor, Optional[Tensor]]:
    """One spiking residual block over ``s [T,B,S,d]`` given its keys
    (:func:`_layer_keys`) -> ``(s, aux)``: residuals add spike trains
    directly (Table I: no inter-layer normalisation).  An SSD or RG-LRU
    mixer runs on the rate interface (decode the rate, the float mixer,
    re-encode its sigmoid keyed ``keys[7]``), as the reference's does, and
    so does a MoE FFN (``moe_dense``, keyed ``keys[8]``; ``aux`` its
    load-balancing loss, ``None`` without MoE).  On a mesh rank's rows
    (``tile``) the coding draws what the whole batch draws at them; on a
    training mesh (``pctx``) the router's statistics are the batch's."""
    params = _uncut_block(params, cfg, mixer, pctx)
    if mixer in ("attn", "local") and pctx is not None:
        mesh = L.cut_mesh(pctx, params["mixer"]["wq"], -2, cfg.num_heads)
        if mesh is not None:  # the KV groups the rank's heads read
            params = dict(params, mixer=L.own_kv_groups(params["mixer"],
                                                        cfg, mesh))

    def encode(key, y):  # the rows' draws of the whole batch's coding
        if tile is None:
            return SP.rate_encode(key, torch.sigmoid(y), s.shape[0])
        return SP.rate_encode_rows(key, torch.sigmoid(y), s.shape[0],
                                   tile["b0"], tile["batch"])

    if mixer in ("attn", "local"):
        h = _spiking_attention(params["mixer"], s, cfg, keys, backend, tile)
    else:
        h = encode(keys[7], _RECURRENT[mixer][0](
            params["mixer"], SP.rate_decode(s), cfg, pctx=pctx))
    s = s + h.to(s.dtype)
    aux = None
    if "moe" in params:
        # row by row, every expert whole on each rank (a spiking stack's
        # experts are not cut); ``aux`` is these rows' loss, the batch's
        # on a training mesh
        ym, aux = M.moe_apply(params["moe"], SP.rate_decode(s), cfg,
                              impl="dense", pctx=pctx)
        s = s + encode(keys[8], ym).to(s.dtype)
    elif "norm2" in params:
        s = s + _spiking_mlp(params["mlp"], s, keys, backend).to(s.dtype)
    return s, aux


def _apply_block_spiking(params, s: Tensor, cfg, mixer: str, key: Tensor,
                         backend, tile: Optional[Dict[str, int]] = None
                         ) -> Tensor:
    """The reference's spiking residual block (``mixer`` ``"attn"`` or
    ``"local"``: the spiking attention sees the whole causal prefix in
    both, as in the reference; ``"ssd"``/``"rglru"`` on the rate
    interface), keyed by the block's ``key``.  Returns the new spike
    trains (a MoE block's auxiliary loss dropped)."""
    return _block_spiking(params, s, cfg, _layer_keys(key), backend, tile,
                          mixer)[0]


def _embed_inputs(params, batch: Dict[str, Tensor], cfg,
                  pctx: Optional[M.ParallelCtx] = None) -> Tensor:
    """Token embedding (a frontend arch: its precomputed embeddings
    through the projection) times ``sqrt(d_model)`` in the model dtype.
    On a training mesh the table or projection is gathered over ``data``
    (ZeRO-3) and a table cut over ``model`` looks up the rank's vocabulary
    block (:func:`repro_torch.models.layers.embed`)."""
    dt = model_dtype(cfg)
    if cfg.frontend != "none":
        proj = _uncut_leaf(params["frontend"]["proj"], 1, cfg, pctx)
        x = batch["embeddings"].to(dt) @ proj.to(dt)
    else:
        table = _uncut_leaf(params["embed"]["table"], 1, cfg, pctx)
        x = L.embed({"table": table}, batch["tokens"], dt,
                    _vocab_mesh(table, cfg, pctx))
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt, device=x.device)


def _zero3(pctx: Optional[M.ParallelCtx]) -> bool:
    """Whether a training mesh cuts the ``embed`` axis over ``data``."""
    return pctx is not None and pctx.train and pctx.fsdp


def _uncut_leaf(w: Tensor, axis: int, cfg, pctx) -> Tensor:
    """``w`` whole along its ``embed`` ``axis``: gathered over ``data``
    where ZeRO-3 cut it (:meth:`repro_torch.launch.mesh.ServingMesh.
    gather_data_freed`: the gradient reduce-scattered back, the whole
    tensor not kept for the backward)."""
    if not _zero3(pctx) or w.shape[axis] == cfg.d_model:
        return w
    return pctx.mesh.gather_data_freed(w, axis)


def _uncut_block(params, cfg, mixer: str, pctx):
    """A block's leaves with every ``embed`` axis gathered over ``data``
    (ZeRO-3), just before the block runs (inside its ``remat`` wrapper);
    the model cuts stay.  The experts' ``d_ff`` is the MoE's own
    (:mod:`repro_torch.models.moe`)."""
    if not _zero3(pctx):
        return params
    from repro_torch.parallel.sharding import block_axes

    axes = block_axes(mixer)
    out = {}
    for group, leaves in params.items():
        ax = axes.get(group, {})
        out[group] = {n: (_uncut_leaf(w, ax[n].index("embed"), cfg, pctx)
                          if "embed" in ax.get(n, ()) else w)
                      for n, w in leaves.items()}
    return out


def _vocab_mesh(w: Tensor, cfg, pctx, axis: int = 0):
    """The training mesh whose model group cuts the vocabulary axis
    ``axis`` of ``w`` (the table's rows, the unembedding's columns), else
    ``None``."""
    return L.cut_mesh(pctx, w, axis, cfg.vocab_size)


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


def _remat(fn: Callable, remat: str, differentiable: bool = True) -> Callable:
    """``remat`` as a wrapper of one layer ``fn``: ``"none"`` runs it as it
    is; ``"block"`` and ``"full"`` recompute it in the backward
    (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
    activations, where the reference wraps its period in
    ``jax.checkpoint``.  Every draw is keyed, so the recomputation is
    exact.  Where autograd records nothing, or the layer is not
    differentiable, nothing is kept anyway."""
    if remat not in ("none", "block", "full"):
        raise ValueError(f"remat must be none|block|full, got {remat!r}")
    if remat == "none" or not torch.is_grad_enabled() or not differentiable:
        return fn

    def run(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)

    return run


def _layers(params, cfg, tree=None):
    """``(layer index, block params, mixer, block of tree)`` in layer
    order: the stacked periods' views, then the remainder.  ``tree`` (a
    cache or page pool, indexed like the params) is optional."""
    layer = 0
    for p in range(cfg.num_periods):
        pp = _take(params["periods"], p)
        pt = None if tree is None else _take(tree["periods"], p)
        for i, mixer in enumerate(cfg.block_pattern):
            yield (layer, pp[f"blk{i}"], mixer,
                   None if pt is None else pt[f"blk{i}"])
            layer += 1
    for i in range(cfg.remainder_layers):
        yield (layer, params["remainder"][f"blk{i}"], cfg.block_pattern[i],
               None if tree is None else tree["remainder"][f"blk{i}"])
        layer += 1


def spiking_features(params, batch: Dict[str, Tensor], cfg, *, rng: Tensor,
                     backend, rows: Optional[Tuple[int, int]] = None,
                     remat: str = "none",
                     pctx: Optional[M.ParallelCtx] = None
                     ) -> Tuple[Tensor, Tensor]:
    """The spiking forward up to the unembed: embed, rate coding, every
    block, rate decoding -> ``([B, S, d]`` in the model dtype, the MoE
    blocks' summed load-balancing loss ``aux``).  ``rows =
    (b0, n)`` runs batch rows ``b0 .. b0+n`` only (a mesh rank's share):
    the coding draws at the whole batch's shape and the SSA tiles at the
    whole batch's grid, so the rows equal those of the whole batch.
    ``remat`` (:func:`_remat`) trades a layer's kept activations for its
    recomputation in training.

    The key chain runs on the host (a few tiny threefry calls, not a few
    hundred kernel launches); the keys move to the card once."""
    if rng is None:
        raise ValueError("the spiking forward needs an rng for Bernoulli "
                         "coding")
    x = _embed_inputs(params, batch, cfg, pctx)
    dev = x.device
    k_enc, k_blocks = prng.split(rng.cpu())
    s = SP.rate_encode(k_enc.to(dev), torch.sigmoid(x), cfg.spike_T)
    tile = None
    if rows is not None:
        b0, n = rows
        tile = {"b0": b0, "batch": s.shape[1]}
        s = s[:, b0:b0 + n]
    lkeys = _layer_keys(_block_keys(k_blocks, cfg)).to(dev)
    block = _remat(_block_spiking, remat,
                   getattr(backend, "differentiable", False))
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for layer, bp, mixer, _ in _layers(params, cfg):
        s, a = block(bp, s, cfg, lkeys[layer], backend, tile, mixer, pctx)
        if a is not None:
            aux = aux + a
    # rate-decode the stream (paper: loss on the time-averaged output)
    return SP.rate_decode(s.to(torch.float32)).to(model_dtype(cfg)), aux


def _forward_spiking(params, batch, cfg, *, rng, backend,
                     remat: str = "none", rows=None, pctx=None):
    """Spiking forward: rate-encode, spiking blocks over T, rate-decode,
    unembed -> ``(logits [B,S,V], aux)`` (``rows``: those rows only)."""
    x, aux = spiking_features(params, batch, cfg, rng=rng, backend=backend,
                              remat=remat, rows=rows, pctx=pctx)
    return _unembed(params, x, cfg, pctx), aux


# ---------------------------------------------------------------------------
# Float (conventional) stack
# ---------------------------------------------------------------------------


def _ffn(params, h: Tensor, cfg, moe_impl: str,
         pctx: Optional[M.ParallelCtx] = None
         ) -> Tuple[Tensor, Optional[Tensor]]:
    """A float block's FFN of the normed ``h``: the MoE's output (routed
    over the model group of ``pctx`` on a mesh) plus the MLP's (arctic's
    dense residual, or a dense block's), as the reference sums them into
    one ``y`` -> ``(y, aux)``, ``aux`` ``None`` without MoE."""
    y = aux = None
    if "moe" in params:
        y, aux = M.moe_apply(params["moe"], h, cfg, impl=moe_impl, pctx=pctx)
    if "mlp" in params:
        m = L.mlp(params["mlp"], h, cfg, pctx)
        y = m if y is None else y + m
    return y, aux


def _apply_block(params, x: Tensor, positions: Tensor, cfg, mixer: str,
                 moe_impl: str, pctx: Optional[M.ParallelCtx] = None
                 ) -> Tuple[Tensor, Optional[Tensor]]:
    """Residual block: norm -> mixer -> +res; norm -> FFN (MLP, MoE or
    both) -> +res -> ``(x, aux)`` (:func:`_ffn`).  On a training mesh the
    block's ZeRO-3 leaves are gathered first (:func:`_uncut_block`)."""
    params = _uncut_block(params, cfg, mixer, pctx)
    h = L.apply_norm(cfg.norm_type, params["norm1"], x)
    if mixer == "attn":
        h = L.attention(params["mixer"], h, positions, cfg, pctx=pctx)
    elif mixer == "local":
        h = L.attention(params["mixer"], h, positions, cfg,
                        window=cfg.window_size, pctx=pctx)
    else:
        h = _RECURRENT[mixer][0](params["mixer"], h, cfg, pctx=pctx)
    x = x + h
    aux = None
    if "norm2" in params:
        y, aux = _ffn(params, L.apply_norm(cfg.norm_type, params["norm2"], x),
                      cfg, moe_impl, pctx)
        x = x + y
    return x, aux


def _forward_float(params, batch, cfg, *, remat: str = "block",
                   moe_impl: str = "ep_a2a",
                   pctx: Optional[M.ParallelCtx] = None):
    """The float forward -> ``(logits [B,S,V], aux)``."""
    x = _embed_inputs(params, batch, cfg, pctx)
    b, sl, _ = x.shape
    positions = torch.arange(sl, dtype=torch.int32, device=x.device).expand(b, sl)
    block = _remat(_apply_block, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, bp, mixer, _ in _layers(params, cfg):
        x, a = block(bp, x, positions, cfg, mixer, moe_impl, pctx)
        if a is not None:
            aux = aux + a
    return _unembed(params, x, cfg, pctx), aux


def forward(params, batch: Dict[str, Tensor], cfg, *,
            rng: Optional[Tensor] = None, backend=None, remat: str = "block",
            rows: Optional[Tuple[int, int]] = None,
            moe_impl: str = "ep_a2a",
            pctx: Optional[M.ParallelCtx] = None) -> Tuple[Tensor, Tensor]:
    """Train/prefill forward: ``batch["tokens"] [B,S]`` (a frontend arch:
    ``batch["embeddings"] [B,S,frontend_dim]``) -> ``(logits [B,S,V],
    aux)``; ``aux`` is MoE's load-balancing loss summed over the blocks
    (zero without MoE).  A float stack's MoE blocks run ``moe_impl``
    (``"ep_a2a"``, the reference's default: the sort-based dispatch with
    its capacity drops; ``"dense"``: every expert); a spiking stack's run
    ``"dense"`` on the rate interface, as the reference's do.  A spiking stack
    runs on ``backend`` (default: the CUDA one, :func:`repro_torch.engine.
    get_backend`; the reference backend, ``"reference"``, is the one
    autograd trains through) and needs ``rng``; a float stack needs
    neither.  ``remat`` applies where autograd records (:func:`_remat`).
    ``rows = (b0, n)``: the logits of batch rows ``b0 .. b0+n`` only,
    equal to those rows of the whole batch's (a data rank's share,
    :func:`spiking_features`).  ``pctx`` places a float stack's MoE blocks
    on a mesh (:class:`repro_torch.models.moe.ParallelCtx`); on a training
    mesh whose model axis cuts the vocabulary the logits are the rank's
    block of it."""
    if not cfg.spiking:
        if rows is not None:
            batch = {k: v[rows[0]:rows[0] + rows[1]] for k, v in batch.items()}
        return _forward_float(params, batch, cfg, remat=remat,
                              moe_impl=moe_impl, pctx=pctx)
    from repro_torch.engine import get_backend

    return _forward_spiking(params, batch, cfg, rng=rng,
                            backend=get_backend(backend), remat=remat,
                            rows=rows, pctx=pctx)


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
            rows: Optional[Tuple[int, int]] = None,
            moe_impl: str = "ep_a2a",
            pctx: Optional[M.ParallelCtx] = None
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Next-token loss of ``batch["tokens"] [B, S+1]`` (inputs all but the
    last, targets all but the first; a frontend arch: ``batch
    ["embeddings"]`` and ``batch["targets"]``; ``batch["mask"]``
    optional) -> ``(loss, {"xent", "moe_aux"})``; differentiable (a
    spiking stack on the reference backend).  ``rows = (b0, n)``: the mean
    over those rows of the batch only, drawn as the whole batch draws them
    (a data rank's share).

    On a training mesh (``pctx`` with ``train``, and ``rows`` the rank's)
    the loss and ``xent`` are the global batch's: their values are summed
    over the ranks that split the rows, while their gradient is that of
    this rank's share of the mean (its rows' sum over the batch's count),
    so the gradients summed over those ranks are the global loss's.
    ``moe_aux`` is the batch's (:func:`repro_torch.models.moe.router`).
    With ZeRO-3 the forward runs in :func:`repro_torch.launch.mesh.
    regathered_saves` (no layer's gathered weights kept for the
    backward), and a vocabulary cut over ``model`` gives each rank its
    block of the logits, whose cross-entropy is the vocab-parallel one
    (:func:`_vocab_nll`)."""
    from repro_torch.launch.mesh import regathered_saves

    with regathered_saves() if _zero3(pctx) else contextlib.nullcontext():
        if cfg.frontend != "none":
            inputs = {"embeddings": batch["embeddings"]}
            targets = batch["targets"]
        else:
            inputs = {"tokens": batch["tokens"][:, :-1]}
            targets = batch["tokens"][:, 1:]
        logits, aux = forward(params, inputs, cfg, rng=rng, backend=backend,
                              remat=remat, rows=rows, moe_impl=moe_impl,
                              pctx=pctx)
        mask = batch.get("mask")
        n_rows = targets.shape[0]
        if rows is not None:
            cut = slice(rows[0], rows[0] + rows[1])
            targets = targets[cut]
            mask = None if mask is None else mask[cut]
        if pctx is None or not pctx.train:
            xent = softmax_xent(logits, targets, mask)
        else:
            xent = _global_xent(logits, targets, mask, n_rows, pctx,
                                _vocab_mesh(logits, cfg, pctx, -1))
        return xent + aux_weight * aux, {"xent": xent, "moe_aux": aux}


def _vocab_nll(logits: Tensor, targets: Tensor, mesh) -> Tensor:
    """Each row's ``logsumexp - gold`` in float32 from the rank's block of
    the vocabulary (``logits [..., V / model]``, block ``model_index``):
    the row maximum over the model group (a stabiliser, no gradient), the
    sum of exponentials over the group, and the gold logit from the rank
    that holds it (the others add zero).  Both sums carry the gradient
    back to every rank's block; the logits are never gathered whole."""
    lf = logits.to(torch.float32)
    n = lf.shape[-1]
    m = mesh.all_reduce(torch.amax(lf.detach(), dim=-1, keepdim=True),
                        ("model",), torch.distributed.ReduceOp.MAX)
    lse = m[..., 0] + torch.log(mesh.reduce_from_model(
        torch.sum(torch.exp(lf - m), dim=-1)))
    local = targets.long() - mesh.model_index * n
    mine = (local >= 0) & (local < n)
    gold = torch.take_along_dim(lf, local.clamp(0, n - 1)[..., None],
                                dim=-1)[..., 0]
    return lse - mesh.reduce_from_model(torch.where(mine, gold, 0.0))


def _global_xent(logits: Tensor, targets: Tensor, mask: Optional[Tensor],
                 n_rows: int, pctx: M.ParallelCtx, vocab_mesh=None) -> Tensor:
    """A training rank's cross-entropy term: the value of the global
    batch's mean, the gradient of this rank's share of it (see
    :func:`loss_fn`); ``vocab_mesh``: the logits are the rank's block of
    the vocabulary (:func:`_vocab_nll`)."""
    axes = pctx.token_axes(False)
    mesh = pctx.mesh
    if mask is None and vocab_mesh is None:
        share = softmax_xent(logits, targets) * (targets.shape[0] / n_rows)
    elif mask is None:
        share = torch.mean(_vocab_nll(logits, targets, vocab_mesh)) * (
            targets.shape[0] / n_rows)
    else:
        lf = logits.to(torch.float32)
        nll = (torch.logsumexp(lf, dim=-1) - torch.take_along_dim(
            lf, targets[..., None].long(), dim=-1)[..., 0]
            if vocab_mesh is None else _vocab_nll(lf, targets, vocab_mesh))
        mask = mask.to(torch.float32)
        total = mesh.all_reduce(torch.sum(mask).detach(), axes)
        share = torch.sum(nll * mask) / torch.clamp(total, min=1.0)
    value = mesh.all_reduce(share.detach().clone(), axes)
    return share + (value - share).detach()


def prefill(params, batch, cfg, *, rng: Optional[Tensor] = None,
            backend=None, moe_impl: str = "ep_a2a",
            pctx: Optional[M.ParallelCtx] = None):
    """Prefill forward returning ``(logits, aux)`` (the cache is produced
    by the decode over the prompt in serving).  The reference's
    ``prefill`` passes no rng to ``forward``, so a spiking config fails
    its assertion there; this one takes the rng and the backend the
    spiking forward needs."""
    return forward(params, batch, cfg, rng=rng, backend=backend,
                   remat="none", moe_impl=moe_impl, pctx=pctx)


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def _per_block(cfg, blk) -> Dict[str, Any]:
    """``blk(mixer, lead)`` for every block: stacked ``periods`` leaves
    get a leading period axis, ``remainder`` leaves none."""
    out: Dict[str, Any] = {}
    if cfg.num_periods > 0:
        out["periods"] = {f"blk{i}": blk(m, (cfg.num_periods,))
                          for i, m in enumerate(cfg.block_pattern)}
    if cfg.remainder_layers:
        out["remainder"] = {f"blk{i}": blk(cfg.block_pattern[i], ())
                            for i in range(cfg.remainder_layers)}
    return out


def init_cache(cfg, batch: int, seq_len: int, device,
               kv_heads: Optional[int] = None) -> Dict[str, Any]:
    """Zero per-slot decode caches, one per block (stacked periods get a
    leading period axis), each with its ``pos [B]`` int32:

    * a spiking SSA stack's attention: the spike-train cache ``sk``/``sv
      [B, T, L, KV, hd]`` uint8 (positions past ``pos`` hold zero spikes,
      which masks them out of the SSA comparators); ``kv_heads``
      (default: all) is the KV heads a mesh rank caches;
    * float attention: ``k``/``v [B, L, KV, hd]``, a windowed layer's
      ``L`` its window (a ring buffer), whole over a mesh's ``model``
      axis (the reference splits its length there, a layout of the same
      values);
    * SSD: ``ssd [B, H, S, P]``, ``conv_x``, ``conv_bc``; RG-LRU: ``h [B,
      W]`` float32, ``conv``."""

    def blk(mixer, lead):
        if mixer in ("attn", "local") and spiking_decode_enabled(cfg):
            kv, hd = kv_heads or cfg.num_kv_heads, cfg.resolved_head_dim
            shape = lead + (batch, cfg.spike_T, seq_len, kv, hd)
            return {"sk": torch.zeros(shape, dtype=torch.uint8, device=device),
                    "sv": torch.zeros(shape, dtype=torch.uint8, device=device),
                    "pos": torch.zeros(lead + (batch,), dtype=torch.int32,
                                       device=device)}
        if mixer in ("attn", "local"):
            window = cfg.window_size if mixer == "local" else 0
            return L.attention_cache(cfg, batch, seq_len, device,
                                     window=window, lead=lead)
        if mixer == "ssd":
            return S.ssd_cache(cfg, batch, device, lead)
        return R.rglru_cache(cfg, batch, device, lead)

    return _per_block(cfg, blk)


def init_paged_pool(cfg, n_pages: int, page_len: int, device,
                    kv_heads: Optional[int] = None) -> Dict[str, Any]:
    """An all-zero page pool: ``kp``/``vp [n_pages, T, KV, page_len, hd]``
    uint8 per attention block, no slot axis (slots address pages through
    a page table).  Page 0 is the permanently zero null page (unallocated
    table entries read as zero spikes), page 1 the trash page idle slots
    write into (never in a table).  ``kv_heads`` (default: all) is the KV
    heads a mesh rank holds."""
    if not paged_decode_supported(cfg):
        raise ValueError(f"{cfg.name}: paged decode needs a spiking SSA "
                         "stack of attention blocks")
    kv, hd = kv_heads or cfg.num_kv_heads, cfg.resolved_head_dim

    def blk(mixer, lead):
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
                                  part="row", group="mixer")


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


def _spiking_decode_ffn_tail(params, s: Tensor, cfg, backend,
                             keys_for: Callable[[int], Tensor]) -> Tensor:
    """The FFN half of a spiking decode block: ``s + LIF(W2 LIF(W1 s))``,
    or a MoE block's on the rate interface (``moe_dense`` of the rate,
    its sigmoid coded with the keys ``keys_for(200003)``)."""
    if "norm2" not in params:
        return s
    if "moe" in params:
        rate = SP.rate_decode(s.to(torch.float32)).to(model_dtype(cfg))
        ym, _ = M.moe_apply(params["moe"], rate, cfg, impl="dense")
        return s + _slot_rate_encode(keys_for(200003), ym, s.shape[0])
    h1 = backend.spiking_linear(
        _lin_operand(params["mlp"]["wi"], s.shape[-1]), s, part="col")
    return s + backend.spiking_linear(
        _lin_operand(params["mlp"]["wo"], h1.shape[-1]),
        h1.to(s.dtype), part="row", group="mlp").to(s.dtype)


def _fused_block_weights(params, cfg, d: int):
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    mx = params["mixer"]
    wq = _lin_operand(mx["wq"], d)
    wk = _lin_operand(mx["wk"], d)
    wv = _lin_operand(mx["wv"], d)
    wo = _lin_operand(mx["wo"], h * hd)
    with_mlp = "norm2" in params and "moe" not in params
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
    draws ``fold_in(slot_key, tag + uid)``.  An SSD or RG-LRU mixer runs on
    the rate interface over its float cache, re-encoded with tag
    100003, as the reference's does."""
    def keys_for(tag):
        return prng.fold_in(slot_keys, tag + uid)

    mixer = cfg.block_pattern[uid % cfg.period]
    if mixer not in ("attn", "local"):
        rate = SP.rate_decode(s.to(torch.float32)).to(model_dtype(cfg))
        y, _ = _RECURRENT[mixer][1](params["mixer"], rate, cache, cfg)
        s = s + _slot_rate_encode(keys_for(100003), y, s.shape[0])
        return _spiking_decode_ffn_tail(params, s, cfg, backend, keys_for)
    if plan is not None and plan.fused:
        return _fused_block_spiking_decode(params, s, cache, cfg, keys_for(1),
                                           backend)
    h = _spiking_attention_decode(params["mixer"], s, cache, cfg, keys_for(1),
                                  backend)
    s = s + h.to(s.dtype)
    return _spiking_decode_ffn_tail(params, s, cfg, backend, keys_for)


def _apply_block_spiking_decode_paged(params, s: Tensor, blk_pool, cfg,
                                      page_table: Tensor, pos: Tensor,
                                      write_pids: Tensor, slot_keys, uid: int,
                                      backend,
                                      plan: Optional[DecodePlan] = None
                                      ) -> Tensor:
    """Spiking residual block over the page pool (decode flavour); the
    same draws as :func:`_apply_block_spiking_decode`."""
    def keys_for(tag):
        return prng.fold_in(slot_keys, tag + uid)

    if plan is not None and plan.fused:
        return _fused_block_spiking_decode_paged(
            params, s, blk_pool, cfg, page_table, pos, write_pids,
            keys_for(1), backend)
    h = _spiking_attention_decode_paged(params["mixer"], s, blk_pool, cfg,
                                        page_table, pos, write_pids,
                                        keys_for(1), backend)
    s = s + h.to(s.dtype)
    return _spiking_decode_ffn_tail(params, s, cfg, backend, keys_for)


def _unembed(params, x: Tensor, cfg, pctx: Optional[M.ParallelCtx] = None
             ) -> Tensor:
    """The final norm and the unembedding (tied: the table transposed).
    On a training mesh: the ZeRO-3 leaves gathered over ``data``, and
    where ``model`` cuts the vocabulary the rank's block of the logits
    (its columns; never gathered whole)."""
    x = L.apply_norm(cfg.norm_type, {"scale": _uncut_leaf(
        params["final_norm"]["scale"], 0, cfg, pctx)}, x)
    if cfg.tie_embeddings:
        table = _uncut_leaf(params["embed"]["table"], 1, cfg, pctx)
        mesh = _vocab_mesh(table, cfg, pctx)
        if mesh is not None:
            x = mesh.copy_to_model(x)
        return torch.matmul(x, table.to(x.dtype).T)
    w = _uncut_leaf(params["unembed"]["w"], 0, cfg, pctx)
    return L.unembed({"w": w}, x, cfg, _vocab_mesh(w, cfg, pctx, 1))


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
    for uid, bp, _, bt in _layers(params, cfg, tree):
        s = block(bp, s, bt, uid)
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


def _apply_block_decode(params, x: Tensor, cache, cfg, mixer: str,
                        moe_impl: str, pctx: Optional[M.ParallelCtx] = None
                        ) -> Tensor:
    """A float residual block, decode flavour: its cache is updated in
    place.  A MoE block routes the step's ``B`` tokens (the ``"ep_a2a"``
    capacities are those of ``B`` tokens, so its decode need not equal
    its forward; on a mesh, over the model group of ``pctx``)."""
    h = L.apply_norm(cfg.norm_type, params["norm1"], x)
    if mixer in ("attn", "local"):
        window = cfg.window_size if mixer == "local" else 0
        h, _ = L.attention_decode(params["mixer"], h, cache, cfg,
                                  window=window)
    else:
        h, _ = _RECURRENT[mixer][1](params["mixer"], h, cache, cfg)
    x = x + h
    if "norm2" in params:
        x = x + _ffn(params, L.apply_norm(cfg.norm_type, params["norm2"], x),
                     cfg, moe_impl, pctx)[0]
    return x


def _decode_step_float(params, cache, tokens: Tensor, cfg,
                       moe_impl: str, pctx: Optional[M.ParallelCtx] = None
                       ) -> Tensor:
    """The float decode step: tokens ``[B,1]`` -> logits ``[B,1,V]`` (a
    frontend arch decodes its tokens through the embedding, as the
    reference's does)."""
    dt = model_dtype(cfg)
    x = L.embed(params["embed"], tokens, dt) * torch.tensor(
        math.sqrt(cfg.d_model), dtype=dt, device=tokens.device)
    for _, bp, mixer, bc in _layers(params, cfg, cache):
        x = _apply_block_decode(bp, x, bc, cfg, mixer, moe_impl, pctx)
    return _unembed(params, x, cfg)


def decode_step(params, cache, tokens: Tensor, cfg, *, backend=None,
                seeds: Optional[Tensor] = None, with_activity: bool = False,
                plan: Optional[DecodePlan] = None, moe_impl: str = "ep_a2a",
                pctx: Optional[M.ParallelCtx] = None):
    """One decode step: tokens ``[B,1]`` -> ``(logits [B,1,V], cache)``
    (plus ``activity [B]`` with ``with_activity``).  The cache is updated
    in place and returned.  A spiking SSA stack decodes through
    ``backend``'s primitives (``seeds [B]``, the per-slot PRN stream ids,
    zeros by default; ``plan`` picks the fused layer kernel); every other
    stack, a LIF-attention one included, on the float path, which ignores
    ``backend``, ``seeds`` and ``plan`` and whose activity is zero, and
    whose MoE blocks run ``moe_impl`` over the model group of ``pctx`` on
    a mesh (a spiking SSA stack's run ``"dense"`` on the rate interface,
    as the reference's do)."""
    if not spiking_decode_enabled(cfg):
        logits = _decode_step_float(params, cache, tokens, cfg, moe_impl,
                                    pctx)
        if with_activity:
            return logits, cache, torch.zeros(
                tokens.shape[0], dtype=torch.float32, device=tokens.device)
        return logits, cache
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
