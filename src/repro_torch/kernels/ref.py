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

import functools
from typing import List, Optional, Tuple, Union

import torch

from repro_torch import prng
from repro_torch.core.aimc import div_const

Tensor = torch.Tensor
Triple = Tuple[Tensor, Tensor, Optional[Tensor]]


def aimc_counts_ref(x: Tensor, w_levels: Tensor) -> Tensor:
    """Exact integer crossbar counts ``[T,B,d_in] x [d_in,d_out]`` as f32
    (pre-scale, pre-LIF): K5's plain version, and the first step of
    every spiking linear here."""
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


def lif_counts_ref(counts: Tensor, scale: Tensor, bias: Optional[Tensor], *,
                   beta: float = 0.5, v_thresh: float = 1.0) -> Tensor:
    """A row-parallel linear's epilogue: integer-valued ``counts [T, M, N]``
    times ``scale [N]``, plus ``bias [N]`` where given (two roundings, as
    the reference's ``counts * scale`` then ``+ b``), then the LIF ->
    uint8 ``[T, M, N]``.  K4's counts entry's plain version."""
    pre = counts.to(torch.float32) * scale.to(torch.float32)
    if bias is not None:
        pre = pre + bias.to(torch.float32)
    t = pre.shape[0]
    return lif_ref(pre.reshape(t, -1), beta=beta,
                   v_thresh=v_thresh).reshape(pre.shape)


def aimc_spiking_linear_ref(spikes: Tensor, w_levels: Tensor, scale: Tensor,
                            bias: Optional[Tensor] = None, *,
                            beta: float = 0.5, v_thresh: float = 1.0
                            ) -> Tensor:
    """``[T,B,d_in]`` integer-valued spikes -> ``[T,B,d_out]`` uint8: LIF
    over per-timestep quantised crossbar MVMs."""
    pre = aimc_counts_ref(spikes, w_levels) * scale.to(torch.float32)
    if bias is not None:
        pre = pre + bias.to(torch.float32)
    return lif_ref(pre, beta=beta, v_thresh=v_thresh)


def _per_matrix(x, device) -> Tensor:
    """A scalar, or a tensor over a state's leading axes, as f32 broadcast
    over the trailing ``[d_in, d_out]``."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x[..., None, None] if x.ndim else x


def drift_factor_ref(nu: Tensor, t_seconds, t0: float) -> Tensor:
    """``exp(-nu * log(max(t, t0) / t0))`` in f32, in the reference's op
    order (``repro/kernels/ref.py:159-160``).  ``t_seconds`` is a scalar
    or one time per leading index of ``nu [..., d_in, d_out]``."""
    t = torch.clamp_min(_per_matrix(t_seconds, nu.device), t0)
    return torch.exp(-nu * torch.log(div_const(t, t0)))


def drift_fold_ref(levels: Tensor, eps: Tensor, df: Tensor, img_gain=1.0
                   ) -> Tensor:
    """``clip(round((levels + eps) * df * img_gain), -127, 127)`` to int8:
    the fold of a given drift factor onto the image grid.  ``img_gain`` is
    a scalar or one gain per leading index."""
    g = (levels + eps) * df
    g = g * _per_matrix(img_gain, levels.device)
    return torch.clamp(torch.round(g), -127, 127).to(torch.int8)


def drift_requantize_ref(levels: Tensor, eps: Tensor, nu: Tensor, t_seconds,
                         *, t0: float, img_gain=1.0) -> Tensor:
    """The digital execution image of a drifted PCM array
    (``repro.kernels.ref.drift_requantize_ref``): the drift factor of
    :func:`drift_factor_ref` folded by :func:`drift_fold_ref`.  K6's plain
    version; ``t_seconds`` and ``img_gain`` are scalars or one value per
    leading index of ``levels [..., d_in, d_out]``."""
    return drift_fold_ref(levels, eps, drift_factor_ref(nu, t_seconds, t0),
                          img_gain)


def img_gain_ref(img_inv: Tensor) -> Tensor:
    """The image grid frozen at program time: ``round(1 / img_inv)`` (the
    rounding repairs the f32 reciprocal, e.g. of 1/7)."""
    return torch.round(1.0 / img_inv)


def drift_fold_leaves_ref(leaves, *, t0: float) -> List[Tensor]:
    """Grouped K6's plain version: each ``(levels, eps, nu, t_seconds or
    None (t = 0), img_inv)`` leaf's int8 image by
    :func:`drift_requantize_ref` at the gain :func:`img_gain_ref`."""
    return [drift_requantize_ref(lv, eps, nu, 0.0 if t is None else t, t0=t0,
                                 img_gain=img_gain_ref(inv))
            for lv, eps, nu, t, inv in leaves]


def drift_abs_sums_ref(leaves, *, t0: float) -> Tensor:
    """The calibration read's plain version: each matrix's sum of
    ``|image|`` over the images of :func:`drift_fold_leaves_ref`, int64
    over every matrix of every leaf in order."""
    sums = [torch.sum(torch.abs(img.to(torch.int64)), dim=(-2, -1)).reshape(-1)
            for img in drift_fold_leaves_ref(leaves, t0=t0)]
    return torch.cat(sums)


def aimc_programmed_linear_ref(spikes: Tensor, levels: Tensor, eps: Tensor,
                               nu: Tensor, scale: Tensor, t_seconds,
                               gdc_gain, bias: Optional[Tensor] = None, *,
                               t0: float, img_gain: int = 1,
                               beta: float = 0.5, v_thresh: float = 1.0
                               ) -> Tensor:
    """The programmed-state spiking linear at a fixed device time
    (``repro/kernels/ref.py:163-190``): the drifted int8 image and the
    per-column ``scale * gdc_gain / img_gain`` (this oracle's op order;
    :attr:`repro_torch.aimc_device.AIMCDeviceState.eff_scale` keeps the
    state's), then :func:`aimc_spiking_linear_ref`."""
    levels_t = drift_requantize_ref(levels, eps, nu, t_seconds, t0=t0,
                                    img_gain=float(img_gain))
    eff_scale = div_const(scale * gdc_gain, float(img_gain)).to(torch.float32)
    return aimc_spiking_linear_ref(spikes, levels_t, eff_scale, bias,
                                   beta=beta, v_thresh=v_thresh)


def ssa_attention_ref(q: Tensor, k: Tensor, v: Tensor, rs: Tensor,
                      ra: Tensor, *, causal: bool = False) -> Tensor:
    """The full SSA tile (Algorithm 1 with explicit comparator integers):
    ``q``/``k``/``v [G,N,D]`` binary, ``rs [G,N,N]`` in ``[0, D)``, ``ra
    [G,N,D]`` in ``[0, N)`` -> uint8 ``[G,N,D]``.  Causal: the count of
    ``j > i`` is zero, so that score never fires."""
    counts_s = torch.matmul(q.to(torch.float64),
                            k.to(torch.float64).transpose(-1, -2))
    if causal:
        n = q.shape[1]
        counts_s = counts_s * torch.tril(torch.ones((n, n), dtype=torch.float64,
                                                    device=q.device))
    s = (counts_s > rs).to(torch.float64)
    counts_a = torch.matmul(s, v.to(torch.float64))
    return (counts_a > ra).to(torch.uint8)


def ssa_decode_ref(q: Tensor, k: Tensor, v: Tensor, rs: Tensor, ra: Tensor
                   ) -> Tensor:
    """One-query SSA decode: ``q [G,1,D]``, ``k``/``v [G,L,D]`` binary,
    ``rs [G,1,L]``, ``ra [G,1,D]`` int32 -> ``[G,1,D]`` uint8 (any
    leading axes in place of ``G``).

    Rows beyond a slot's position are zero, so their AND-counts are 0 and
    never beat a non-negative draw: validity masking is implicit."""
    counts_s = torch.matmul(q.to(torch.float64),
                            k.to(torch.float64).transpose(-1, -2))
    s = (counts_s > rs).to(torch.float64)
    counts_a = torch.matmul(s, v.to(torch.float64))
    return (counts_a > ra).to(torch.uint8)


def draw_comparator_prns(key: Tensor, shape_s: Tuple[int, ...],
                         shape_a: Tuple[int, ...], d: int, n: int
                         ) -> Tuple[Tensor, Tensor]:
    """``r_s ~ U{0..d-1}``, ``r_a ~ U{0..n-1}`` from one key (split in
    two), vectorised over the key's leading axes."""
    k = prng.split(key)
    rs = prng.randint(k[..., 0, :], shape_s, 0, d)
    ra = prng.randint(k[..., 1, :], shape_a, 0, n)
    return rs, ra


def check_tile_block(b: int, h: int, b0: int = 0, h0: int = 0,
                     batch: Optional[int] = None,
                     heads: Optional[int] = None) -> Tuple[int, int]:
    """The grid ``(batch, heads)`` of a ``[b, h]`` block of tiles from
    ``(b0, h0)`` (defaults: the block is the grid); raises where the block
    leaves the grid."""
    batch = b if batch is None else batch
    heads = h if heads is None else heads
    if not (0 <= b0 and b0 + b <= batch and 0 <= h0 and h0 + h <= heads):
        raise ValueError(f"tiles [{b0}, {b0 + b}) x [{h0}, {h0 + h}) lie "
                         f"outside a grid of {batch} x {heads}")
    return batch, heads


def tile_index(t: int, b: int, h: int, *, b0: int = 0, h0: int = 0,
               batch: Optional[int] = None, heads: Optional[int] = None,
               device=None) -> Tensor:
    """The flat tile index ``g = (t * batch + b0 + b) * heads + h0 + h``
    of each local tile ``(t, b, h)`` of a ``[T, b, h]`` block that starts at
    batch row ``b0`` and head ``h0`` of a ``[T, batch, heads]`` tile grid
    (defaults: the block is the whole grid): int64 ``[T, b, h]``."""
    batch, heads = check_tile_block(b, h, b0, h0, batch, heads)
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    return ((ar(t)[:, None, None] * batch + b0 + ar(b)[None, :, None])
            * heads + h0 + ar(h)[None, None, :])


def draw_tile_prns(key: Tensor, g: Tensor, n: int, d: int
                   ) -> Tuple[Tensor, Tensor]:
    """:func:`draw_comparator_prns`'s integers of the tiles ``g`` (flat
    tile indices, :func:`tile_index`) of a larger draw: ``rs [*g, N, N]``
    at flat indices ``(g N + i) N + j`` and ``ra [*g, N, D]`` at ``(g N +
    i) D + d``, the draw of the whole grid's shapes at those tiles."""
    k = prng.split(key)
    g = g[..., None, None]
    i = torch.arange(n, dtype=torch.int64, device=g.device)[:, None]
    j_s = torch.arange(n, dtype=torch.int64, device=g.device)[None, :]
    j_a = torch.arange(d, dtype=torch.int64, device=g.device)[None, :]
    rs = prng.randint_at(k[0], (g * n + i) * n + j_s, 0, d)
    ra = prng.randint_at(k[1], (g * n + i) * d + j_a, 0, n)
    return rs, ra


def ssa_attention_keyed_ref(q: Tensor, k: Tensor, v: Tensor, key: Tensor,
                            *, causal: bool = False, b0: int = 0,
                            h0: int = 0, batch: Optional[int] = None,
                            heads: Optional[int] = None) -> Tensor:
    """The full SSA tile with its draws: ``q``/``k``/``v [T,B,H,N,D]``
    binary (any strides), the comparators of :func:`draw_comparator_prns`
    from ``key [2]`` at the logical shapes with the tiles flattened ``G =
    (t, b, h)`` (the reference's wrapper, ``ops.py:83``) -> uint8
    ``[T,B,H,N,D]``.  A shard of a ``[T, batch, heads]`` grid (a mesh
    rank's batch rows from ``b0`` and heads from ``h0``) draws the whole
    grid's comparators at its own tiles (:func:`draw_tile_prns`); the
    defaults are the whole grid.  The keyed K8's plain version."""
    t, b, h, n, d = q.shape
    g = tile_index(t, b, h, b0=b0, h0=h0, batch=batch, heads=heads,
                   device=q.device).reshape(-1)
    rs, ra = draw_tile_prns(key, g, n, d)
    gl = t * b * h
    out = ssa_attention_ref(q.reshape(gl, n, d), k.reshape(gl, n, d),
                            v.reshape(gl, n, d), rs, ra, causal=causal)
    return out.reshape(t, b, h, n, d)


def draw_slot_decode_prns(slot_keys: Tensor, t: int, h: int, l: int, d: int,
                          i_max: int, h0: Union[int, Tensor] = 0
                          ) -> Tuple[Tensor, Tensor]:
    """Per-(slot, global head) comparator integers for one decode step.

    Each slot draws from its own key and each head from ``fold_in(slot_key,
    h0 + head)``, so a stream is ``f(seed, pos, head)`` and never depends
    on the other slots in the batch.  Returns ``rs [B,T*H,1,L]``, ``ra
    [B,T*H,1,D]``, t-major over the ``T*H`` axis.  The keyed K2 draws the
    same chain in registers (``csrc/threefry.cuh``)."""
    b = slot_keys.shape[0]
    heads = torch.as_tensor(h0, dtype=torch.int64, device=slot_keys.device) \
        + torch.arange(h, dtype=torch.int64, device=slot_keys.device)
    kh = prng.fold_in(slot_keys[:, None, :], heads[None, :])  # [B,H,2]
    rs, ra = draw_comparator_prns(kh, (t, 1, l), (t, 1, d), d, i_max)
    return (rs.movedim(1, 2).reshape(b, t * h, 1, l),
            ra.movedim(1, 2).reshape(b, t * h, 1, d))


def ssa_decode_keyed_ref(q: Tensor, k: Tensor, v: Tensor, slot_keys: Tensor,
                         h0: Union[int, Tensor] = 0, *, i_max: int) -> Tensor:
    """The SSA decode row with its draws: ``q [T,B,H,1,D]`` against
    ``k``/``v [T,B,H,L,D]`` (zeros beyond each slot's position), the
    comparators of :func:`draw_slot_decode_prns` from ``slot_keys [B, 2]``
    -> uint8 ``[T,B,H,1,D]``.  The keyed K2's plain version."""
    t, b, h, _, d = q.shape
    l = k.shape[3]
    rs, ra = draw_slot_decode_prns(slot_keys, t, h, l, d, i_max, h0)
    g = b * t * h
    out = ssa_decode_ref(q.movedim(1, 0).reshape(g, 1, d),
                         k.movedim(1, 0).reshape(g, l, d),
                         v.movedim(1, 0).reshape(g, l, d),
                         rs.reshape(g, 1, l), ra.reshape(g, 1, d))
    return out.reshape(b, t, h, 1, d).movedim(0, 1)


def ssa_decode_paged_keyed_ref(q: Tensor, kpool: Tensor, vpool: Tensor,
                               page_table: Tensor, slot_keys: Tensor,
                               h0: Union[int, Tensor] = 0, *, i_max: int
                               ) -> Tensor:
    """The paged SSA decode row with its draws: ``q [T,B,H,1,D]`` against
    the pools ``[P,T,KV,page_len,D]`` through ``page_table [B,MP]``, the
    comparators of :func:`draw_slot_decode_prns` at the logical length ``L
    = MP*page_len`` (the dense layout's streams) -> uint8 ``[T,B,H,1,D]``.
    The keyed K7's plain version; every row is read."""
    t, b, h, _, d = q.shape
    l = page_table.shape[1] * kpool.shape[3]
    rs, ra = draw_slot_decode_prns(slot_keys, t, h, l, d, i_max, h0)
    out = ssa_decode_paged_ref(q.movedim(1, 0), kpool, vpool, page_table,
                               rs.reshape(b, t, h, 1, l),
                               ra.reshape(b, t, h, 1, d))
    return out.movedim(0, 1)


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


def gather_kv_pages_ref(pool: Tensor, page_table: Tensor) -> Tensor:
    """A slot-dense view of a paged spike-train pool: ``pool [P, T, KV,
    page_len, d]`` and ``page_table [B, MP]`` -> ``[T, B, KV, MP*page_len,
    d]``, page ``table[b, j]`` at logical positions ``[j*page_len,
    (j+1)*page_len)``.  Table entry 0 is the permanently zero null page."""
    g = pool[page_table.to(torch.int64)]  # [B, MP, T, KV, page_len, d]
    g = g.movedim(2, 0).transpose(2, 3)  # [T, B, KV, MP, page_len, d]
    return g.reshape(*g.shape[:3], -1, g.shape[-1])


def _ssa_rows(q: Tensor, k: Tensor, v: Tensor, rs: Tensor, ra: Tensor
              ) -> Tensor:
    """One SSA query row per (t, slot, head): ``q [T,B,H,1,D]`` against
    ``k``/``v [T,B,KV,L,D]`` (KV heads repeat over their query-head group),
    ``rs [T,B,H,1,L]``, ``ra [T,B,H,1,D]`` -> uint8 ``[T,B,H,1,D]``."""
    h, kv = q.shape[2], k.shape[2]
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    return ssa_decode_ref(q, k, v, rs, ra)


def ssa_decode_paged_ref(q: Tensor, kpool: Tensor, vpool: Tensor,
                         page_table: Tensor, rs: Tensor, ra: Tensor
                         ) -> Tensor:
    """Paged SSA decode: ``q [B,T,H,1,D]`` against the pools ``[P,T,KV,
    page_len,D]`` through ``page_table [B,MP]``, ``rs [B,T,H,1,L]`` (``L =
    MP*page_len``), ``ra [B,T,H,1,D]`` -> uint8 ``[B,T,H,1,D]``.  Gathers
    the dense view (:func:`gather_kv_pages_ref`), then attends in table
    order; null-page positions hold zero spikes and never fire."""
    out = _ssa_rows(q.movedim(1, 0), gather_kv_pages_ref(kpool, page_table),
                    gather_kv_pages_ref(vpool, page_table), rs.movedim(1, 0),
                    ra.movedim(1, 0))
    return out.movedim(0, 1)


def _attend_rows(q: Tensor, kf: Tensor, vf: Tensor, rs: Tensor, ra: Tensor
                 ) -> Tensor:
    """The fused layer's attention: ``q [T,B,H,hd]``, dense ``kf``/``vf
    [T,B,KV,L,hd]`` post-scatter, ``rs [B,T,H,L]``, ``ra [B,T,H,hd]`` ->
    the attention train ``[T,B,H*hd]`` f32."""
    t, b, h, hd = q.shape
    a = _ssa_rows(q[:, :, :, None, :], kf, vf,
                  rs.movedim(1, 0)[:, :, :, None, :],
                  ra.movedim(1, 0)[:, :, :, None, :])
    return a.to(torch.float32).reshape(t, b, h * hd)


def _layer_ref(s: Tensor, attend, wq: Triple, wk: Triple, wv: Triple,
               wo: Optional[Triple], wi: Optional[Triple],
               wo2: Optional[Triple], *, hd: int, with_tail: bool,
               with_mlp: bool, beta: float, v_thresh: float):
    """Q/K/V spiking linears, ``attend(q, k_new, v_new)`` (the cache
    layout's scatter and SSA row), attention-out, residual, FFN tail."""
    t, b, _ = s.shape
    kw = dict(beta=beta, v_thresh=v_thresh)
    q = _lin_lif_ref(s, wq, **kw).reshape(t, b, -1, hd)
    k_new = _lin_lif_ref(s, wk, **kw).reshape(t, b, -1, hd).to(torch.uint8)
    v_new = _lin_lif_ref(s, wv, **kw).reshape(t, b, -1, hd).to(torch.uint8)
    a = attend(q, k_new, v_new)
    if not with_tail:
        return a, k_new, v_new
    s1 = s + _lin_lif_ref(a, wo, **kw)
    if with_mlp:
        h1 = _lin_lif_ref(s1, wi, **kw)
        s1 = s1 + _lin_lif_ref(h1, wo2, **kw)
    return s1, k_new, v_new


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

    def attend(q, k_new, v_new):
        kf, vf = sk.clone(), sv.clone()
        scatter_at_pos(kf, pos, k_new.movedim(0, 1))
        scatter_at_pos(vf, pos, v_new.movedim(0, 1))
        return _attend_rows(q, kf.permute(1, 0, 3, 2, 4),
                            vf.permute(1, 0, 3, 2, 4), rs, ra)

    return _layer_ref(s, attend, wq, wk, wv, wo, wi, wo2, hd=hd,
                      with_tail=with_tail, with_mlp=with_mlp, beta=beta,
                      v_thresh=v_thresh)


def scatter_into_pages(pool: Tensor, write_pids: Tensor, pos: Tensor,
                       rows: Tensor) -> None:
    """In place: ``pool[write_pids[b], :, :, pos[b] % page_len] =
    rows[b]`` -- each slot's new K/V train into its designated physical
    page.  ``pool [P, T, KV, page_len, hd]``, ``rows [B, T, KV, hd]``."""
    off = (pos % pool.shape[3]).to(torch.int64)
    pool[write_pids.to(torch.int64), :, :, off] = rows.to(pool.dtype)


def decode_layer_paged_ref(s: Tensor, kpool: Tensor, vpool: Tensor,
                           page_table: Tensor, pos: Tensor,
                           write_pids: Tensor, wq: Triple, wk: Triple,
                           wv: Triple, wo: Optional[Triple],
                           wi: Optional[Triple], wo2: Optional[Triple],
                           rs: Tensor, ra: Tensor, *, hd: int,
                           with_tail: bool = True, with_mlp: bool = True,
                           beta: float = 0.5, v_thresh: float = 1.0):
    """Paged twin of :func:`decode_layer_ref`: the new K/V trains scatter
    into each slot's ``write_pids`` page at ``pos % page_len`` (copies of
    the pre-scatter pools), then the SSA row attends over the table-
    gathered logical cache -- content reachable through the table; the
    trash page never is.  ``rs [B,T,H,MP*page_len]``."""

    def attend(q, k_new, v_new):
        kp, vp = kpool.clone(), vpool.clone()
        scatter_into_pages(kp, write_pids, pos, k_new.movedim(0, 1))
        scatter_into_pages(vp, write_pids, pos, v_new.movedim(0, 1))
        return _attend_rows(q, gather_kv_pages_ref(kp, page_table),
                            gather_kv_pages_ref(vp, page_table), rs, ra)

    return _layer_ref(s, attend, wq, wk, wv, wo, wi, wo2, hd=hd,
                      with_tail=with_tail, with_mlp=with_mlp, beta=beta,
                      v_thresh=v_thresh)
