"""Mamba-2's SSD mixer (state-space duality), chunked: the twin of
``repro/models/ssm.py``.

Per head (head dim ``P``, state dim ``S``)::

    h_t = a_t * h_{t-1} + B_t (dt_t x_t)^T        h in R^{S x P}
    y_t = C_t^T h_t + D x_t

Train and prefill run the chunked algorithm of Dao & Gu (arXiv:2405.21060):
chunks of ``ssm_chunk`` tokens, the quadratic form inside a chunk, a short
loop carrying the ``[S, P]`` state across chunks (the reference's
``lax.scan``).  Decode is the O(1) recurrence on a carried state, updated
**in place** in the per-slot cache ``{ssd, conv_x, conv_bc, pos}``.  The
reference's ``_constrain_inner`` is a sharding hint and has no twin on
one device.

On a training mesh whose ``model`` axis cuts ``ssm_heads`` (and so
``ssm_inner``), :func:`ssd_mixer` runs the rank's heads: ``w_z``, ``w_x``,
the ``x`` convolution and the gated norm's scale on the rank's inner
columns, ``w_dt``, ``a_log``, ``dt_bias`` and ``d_skip`` on its heads, the
whole ``w_bc`` branch on every rank (its cotangent summed over the group),
the chunked scan per head, the gated RMSNorm's sum of squares summed over
the group before its ``rsqrt``, and ``w_out``'s rows, summed over the
group.  Where only ``ssm_inner`` divides, its cut leaves are gathered
whole over ``model`` first.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import cut_mesh

Tensor = torch.Tensor


def ssd_dims(cfg) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    return d_inner, heads, cfg.ssm_head_dim, cfg.ssm_state_dim


def ssd_schema(cfg) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Leaf shapes and initialisers (``normal``, ``zeros``, ``ones``)."""
    d = cfg.d_model
    d_in, h, _, s = ssd_dims(cfg)
    gs = 2 * cfg.ssm_n_groups * s
    k = cfg.ssm_conv_width
    return {
        "w_z": ((d, d_in), "normal"),
        "w_x": ((d, d_in), "normal"),
        "w_bc": ((d, gs), "normal"),
        "w_dt": ((d, h), "normal"),
        "conv_x_w": ((k, d_in), "normal"),
        "conv_x_b": ((d_in,), "zeros"),
        "conv_bc_w": ((k, gs), "normal"),
        "conv_bc_b": ((gs,), "zeros"),
        "a_log": ((h,), "ones"),
        "dt_bias": ((h,), "zeros"),
        "d_skip": ((h,), "ones"),
        "norm_scale": ((d_in,), "ones"),
        "w_out": ((d_in, d), "normal"),
    }


def depthwise_causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """``x [B,L,C]``, ``w [K,C]``: the depthwise causal convolution plus
    bias, unrolled over the ``K`` taps (no activation)."""
    k, n = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + n, :] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _ssd_chunked(xh: Tensor, a: Tensor, bmat: Tensor, cmat: Tensor, *,
                 chunk: int = 256) -> Tuple[Tensor, Tensor]:
    """The chunked SSD core: ``xh [B,L,H,P]`` dt-scaled inputs, ``a
    [B,L,H]`` per-step decay in (0, 1] (float32), ``bmat``/``cmat
    [B,L,G,S]`` -> ``y [B,L,H,P]`` and the final state ``[B,H,S,P]``."""
    b, L, h, p = xh.shape
    g, s = bmat.shape[2], bmat.shape[3]
    q = min(chunk, L)
    nc = L // q
    hg = h // g

    def cut(t):
        return t.reshape(b, nc, q, *t.shape[2:])

    xh_c, a_c, b_c, c_c = cut(xh), cut(a), cut(bmat), cut(cmat)
    xg = xh_c.reshape(b, nc, q, g, hg, p)
    la = torch.log(torch.clamp(a_c, min=1e-20))  # [B,NC,Q,H] f32
    cum = torch.cumsum(la, dim=2)

    # intra-chunk (quadratic): the decay is masked BEFORE the exp, so the
    # future entries are exp(-1e30) = 0, never exp(+x) = inf (whose
    # product with the mask's zero would be NaN in the backward)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,NC,Q,Q,H]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    dec = torch.where(mask[None, None, :, :, None], dec, -1e30)
    gamma = torch.exp(dec).to(xh.dtype)
    cb = torch.einsum("bnigs,bnjgs->bnijg", c_c, b_c)  # [B,NC,Q,Q,G]
    gam_h = gamma.reshape(b, nc, q, q, g, hg)
    y_intra = torch.einsum("bnijg,bnijgh,bnjghp->bnighp", cb, gam_h, xg)
    y_intra = y_intra.reshape(b, nc, q, h, p)

    # chunk states
    rem = torch.exp(cum[:, :, -1:, :] - cum).to(xh.dtype)  # [B,NC,Q,H]
    states = torch.einsum("bnqgs,bnqgh,bnqghp->bnghsp", b_c,
                          rem.reshape(b, nc, q, g, hg), xg
                          ).reshape(b, nc, h, s, p)

    # inter-chunk recurrence: the state entering each chunk
    a_chunk = torch.exp(cum[:, :, -1, :]).to(xh.dtype)  # [B,NC,H]
    carry = torch.zeros((b, h, s, p), dtype=xh.dtype, device=xh.device)
    prev = []
    for n in range(nc):
        prev.append(carry)
        carry = carry * a_chunk[:, n, :, None, None] + states[:, n]
    prev_t = torch.stack(prev, dim=1)  # [B,NC,H,S,P]

    into = torch.exp(cum).to(xh.dtype)  # decay chunk start -> step (incl.)
    y_inter = torch.einsum("bnqgs,bnqgh,bnghsp->bnqghp", c_c,
                           into.reshape(b, nc, q, g, hg),
                           prev_t.reshape(b, nc, g, hg, s, p)
                           ).reshape(b, nc, q, h, p)
    return (y_intra + y_inter).reshape(b, L, h, p), carry


def _gated_out(params, y: Tensor, z: Tensor, x_dtype, mesh=None,
               d_in: int = 0) -> Tensor:
    """``y * silu(z)``, RMS-normed over the inner width, scaled and
    projected out; ``mesh``: ``y`` is the rank's ``d_in / model`` columns
    of ``d_in``, the sum of squares (and its cotangent) and the
    projection summed over the model group."""
    y = y * F.silu(z)
    yf = y.to(torch.float32)
    if mesh is None:
        ms = torch.mean(yf * yf, -1, keepdim=True)
    else:
        # the sum is the group's, and so is its cotangent (each rank's
        # columns give a part of it): summed both ways
        ms = mesh.copy_to_model(mesh.reduce_from_model(
            torch.sum(yf * yf, -1, keepdim=True))) / d_in
    y = (yf * torch.rsqrt(ms + 1e-6)).to(x_dtype)
    y = y * params["norm_scale"].to(x_dtype)
    out = y @ params["w_out"].to(x_dtype)
    return out if mesh is None else mesh.reduce_from_model(out)


_INNER_CUT = {"w_z": -1, "w_x": -1, "conv_x_w": -1, "conv_x_b": -1,
              "norm_scale": -1, "w_out": -2}


def _groups_of(bmat: Tensor, cmat: Tensor, h: int, hl: int, h0: int):
    """The B and C groups ``[B, L, G, S]`` that heads ``h0 .. h0+hl`` of
    ``h`` read: a whole number of groups, or the one they lie in."""
    g = bmat.shape[2]
    hg = h // g
    if g == 1:
        return bmat, cmat
    if hl % hg and hg % hl:
        raise NotImplementedError(
            f"{hl} SSD heads a rank straddle the groups of {hg} heads")
    lo, hi = h0 // hg, (h0 + hl - 1) // hg + 1
    return bmat[:, :, lo:hi], cmat[:, :, lo:hi]


def _decay(params, dt: Tensor) -> Tuple[Tensor, Tensor]:
    """``softplus(dt + dt_bias)`` and the decay ``exp(-exp(a_log) *
    dtf)``, in float32."""
    dtf = F.softplus(dt.to(torch.float32) + params["dt_bias"].to(torch.float32))
    return dtf, torch.exp(-torch.exp(params["a_log"].to(torch.float32)) * dtf)


def ssd_mixer(params, x: Tensor, cfg, pctx=None) -> Tensor:
    """The Mamba-2 block for train/prefill: ``x [B,L,D] -> [B,L,D]``; on a
    training mesh's cut, the rank's heads (see the module)."""
    d_in, h, p, s = ssd_dims(cfg)
    g = cfg.ssm_n_groups
    b, L, _ = x.shape
    inner = cut_mesh(pctx, params["w_x"], -1, d_in)
    mesh = cut_mesh(pctx, params["a_log"], -1, h)
    if inner is not None and mesh is None:  # ssm_inner cut, heads whole
        params = {k: (inner.all_gather(v, _INNER_CUT[k], "model")
                      if k in _INNER_CUT else v) for k, v in params.items()}
    xm = x if mesh is None else mesh.copy_to_model(x)
    hl = params["a_log"].shape[-1]
    z = xm @ params["w_z"].to(x.dtype)
    xc = F.silu(depthwise_causal_conv(xm @ params["w_x"].to(x.dtype),
                                      params["conv_x_w"], params["conv_x_b"]))
    bc = F.silu(depthwise_causal_conv(x @ params["w_bc"].to(x.dtype),
                                      params["conv_bc_w"], params["conv_bc_b"]))
    if mesh is not None:  # every rank's heads read B and C
        bc = mesh.copy_to_model(bc)
    bmat, cmat = bc.chunk(2, dim=-1)
    bmat, cmat = bmat.reshape(b, L, g, s), cmat.reshape(b, L, g, s)
    if mesh is not None:
        bmat, cmat = _groups_of(bmat, cmat, h, hl, mesh.model_index * hl)
    dtf, a = _decay(params, xm @ params["w_dt"].to(x.dtype))  # [B,L,H]
    xh = (xc.reshape(b, L, hl, p) * dtf[..., None].to(x.dtype)).to(x.dtype)
    y, _ = _ssd_chunked(xh, a, bmat, cmat, chunk=cfg.ssm_chunk)
    y = y + params["d_skip"].to(x.dtype)[None, None, :, None] * xc.reshape(b, L, hl, p)
    return _gated_out(params, y.reshape(b, L, hl * p), z, x.dtype, mesh,
                      d_in)


def ssd_cache(cfg, batch: int, device, lead: Tuple[int, ...] = ()
              ) -> Dict[str, Tensor]:
    """A zero decode cache (``ssd_cache_schema``): the state ``[B,H,S,P]``,
    the two convolutions' last ``K-1`` inputs and ``pos``."""
    d_in, h, p, s = ssd_dims(cfg)
    gs = 2 * cfg.ssm_n_groups * s
    k = cfg.ssm_conv_width
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def z(*shape, dtype=dt):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    return {"ssd": z(batch, h, s, p), "conv_x": z(batch, k - 1, d_in),
            "conv_bc": z(batch, k - 1, gs),
            "pos": z(batch, dtype=torch.int32)}


def conv_step(hist: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """One output of the causal convolution from its ``K`` inputs ``hist
    [B,K,C]``."""
    return (torch.einsum("bkc,kc->bc", hist, w.to(hist.dtype))
            + b.to(hist.dtype))


def ssd_decode(params, x: Tensor, cache: Dict[str, Tensor], cfg
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode, ``x [B,1,D]``; the cache is updated in place and
    returned."""
    d_in, h, p, s = ssd_dims(cfg)
    g = cfg.ssm_n_groups
    b = x.shape[0]
    z = x @ params["w_z"].to(x.dtype)
    hist_x = torch.cat([cache["conv_x"].to(x.dtype),
                        x @ params["w_x"].to(x.dtype)], dim=1)
    hist_bc = torch.cat([cache["conv_bc"].to(x.dtype),
                         x @ params["w_bc"].to(x.dtype)], dim=1)
    xc = F.silu(conv_step(hist_x, params["conv_x_w"], params["conv_x_b"]))
    bc = F.silu(conv_step(hist_bc, params["conv_bc_w"], params["conv_bc_b"]))
    bmat, cmat = bc.chunk(2, dim=-1)
    dtf, a = _decay(params, x @ params["w_dt"].to(x.dtype))
    dtf, a = dtf[:, 0], a[:, 0]  # [B,H]
    xh = (xc.reshape(b, h, p) * dtf[..., None].to(x.dtype)).to(x.dtype)
    bh = bmat.reshape(b, g, s).repeat_interleave(h // g, dim=1)
    ch = cmat.reshape(b, g, s).repeat_interleave(h // g, dim=1)
    st = (cache["ssd"].to(x.dtype) * a[..., None, None].to(x.dtype)
          + torch.einsum("bhs,bhp->bhsp", bh, xh))
    y = torch.einsum("bhs,bhsp->bhp", ch, st)
    y = y + params["d_skip"].to(x.dtype)[None, :, None] * xc.reshape(b, h, p)
    out = _gated_out(params, y.reshape(b, 1, d_in), z, x.dtype)
    cache["ssd"].copy_(st)
    cache["conv_x"].copy_(hist_x[:, 1:, :])
    cache["conv_bc"].copy_(hist_bc[:, 1:, :])
    cache["pos"] += 1
    return out, cache
