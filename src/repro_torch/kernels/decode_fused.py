"""K3 and K9 launchers: one fused spiking decoder layer step over a dense
slot cache (K3) or a block-paged pool (K9) (``csrc/decode_fused.cu``).

Replace ``repro/kernels/decode_fused.py:fused_decode_layer`` and
``fused_decode_layer_paged``.  The kernel attends over the **pre-scatter**
cache (the row at each slot's ``pos`` is zero by the serving invariant)
and adds the new token's term on top, with its score draw ``rs[b, t, h,
pos[b]]`` (``_INVALID_RS`` where the write is masked: ``pos >= L``, or,
paged, where the slot's table does not show its write page at ``pos``,
as for idle slots writing the trash page); the caller scatters
``k_new``/``v_new`` afterwards.  On a CPU tensor a wrapper runs the plain
version (:func:`repro_torch.kernels.ref.decode_layer_ref` /
:func:`~repro_torch.kernels.ref.decode_layer_paged_ref`, scatter then
attend), which is the same function under that invariant.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels import ref as KREF

Tensor = torch.Tensor
Triple = Tuple[Tensor, Tensor, Optional[Tensor]]
_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)

# a comparator draw no AND-count can beat: disables the new-token term
_INVALID_RS = 2 ** 30


def draw_layer_prns(slot_keys: Tensor, t: int, h: int, l: int, hd: int,
                    h0: Union[int, Tensor] = 0) -> Tuple[Tensor, Tensor]:
    """The unfused path's per-(slot, global head) draws (``r_s ~
    U{0..hd-1}``, ``r_a ~ U{0..L-1}``) as ``rs [B,T,H,L]``, ``ra
    [B,T,H,hd]``."""
    rs, ra = KOPS.draw_slot_decode_prns(slot_keys, t, h, l, hd, l, h0)
    b = slot_keys.shape[0]
    return rs.reshape(b, t, h, l), ra.reshape(b, t, h, hd)


def _rs_at_pos(rs4: Tensor, pos: Tensor, valid: Tensor) -> Tensor:
    """``rs[b, :, :, pos[b]]`` -- the draw the new token's score must beat
    -- forced unbeatable where the write is masked."""
    l = rs4.shape[-1]
    idx = pos.clamp(0, l - 1).to(torch.int64)
    rsp = torch.take_along_dim(rs4, idx[:, None, None, None], dim=3)[..., 0]
    return torch.where(valid[:, None, None], rsp,
                       torch.full_like(rsp, _INVALID_RS))


# the dynamic shared memory a layer-step block may take (the kernel's few
# static bytes aside)
SMEM_BUDGET = KB.SMEM_PER_BLOCK - 64


def _align16(x: int) -> int:
    return (x + 15) & ~15


def layer_smem_bytes(t: int, d: int, h: int, kv: int, hd: int, l: int,
                     dff: int) -> int:
    """Dynamic shared memory of one layer-step block: the segments of
    ``csrc/decode_fused.cu:smem_layout`` (the int32 residual, the q, k_new,
    v_new, attention, FFN hidden and output spike trains over T, the score
    bits of one row, the packed query and new key), each 16-aligned.  The
    launcher refuses any number but its own layout's total."""
    wd = (hd + 31) // 32
    sizes = (4 * t * d, t * h * hd, t * kv * hd, t * kv * hd, t * h * hd,
             t * max(dff, 1), t * d, 4 * ((l + 31) // 32), 4 * wd, 4 * wd)
    total = 0
    for n in sizes:
        total = _align16(total + n)
    return total


def _norm_w(w: Triple) -> Triple:
    lv, sc, bi = w
    if bi is None:
        bi = torch.zeros_like(sc, dtype=torch.float32)
    return (lv.to(torch.int8).contiguous(), sc.to(torch.float32).contiguous(),
            bi.to(torch.float32).contiguous())


def _lib(name: str, n_ptr: int, n_int: int):
    fn = getattr(KB.load("decode_fused"), name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_F, _F, _L, _P]
        fn.restype = ctypes.c_int
    return fn


def fused_decode_layer(slot_keys: Tensor, s: Tensor, sk: Tensor, sv: Tensor,
                       pos: Tensor, wq: Triple, wk: Triple, wv: Triple,
                       wo: Optional[Triple] = None, wi: Optional[Triple] = None,
                       wo2: Optional[Triple] = None,
                       h0: Union[int, Tensor] = 0, *, hd: int,
                       with_tail: bool = True, with_mlp: bool = True,
                       beta: float = 0.5, v_thresh: float = 1.0):
    """One fused spiking decoder layer step over a dense slot cache.

    ``slot_keys [B,2]``, ``s [T,B,d]`` integer-valued f32, ``sk``/``sv
    [B,T,L,KV,hd]`` uint8 pre-scatter, ``pos [B]``, weight triples
    ``(int8 levels [d_in,d_out], f32 scale, f32 bias | None)``.  Returns
    ``(s_out [T,B,d], k_new [T,B,KV,hd] u8, v_new)``; with
    ``with_tail=False`` the attention train ``[T,B,H*hd]`` comes first.
    Draws the comparator integers, then runs
    :func:`fused_decode_layer_kernel`."""
    t = s.shape[0]
    l = sk.shape[2]
    h = wq[0].shape[1] // hd
    rs4, ra4 = draw_layer_prns(slot_keys, t, h, l, hd, h0)
    return fused_decode_layer_kernel(
        s.to(torch.float32).contiguous(), sk.contiguous(), sv.contiguous(),
        pos, wq, wk, wv, wo, wi, wo2, rs4, ra4, hd=hd,
        with_tail=with_tail, with_mlp=with_mlp, beta=beta, v_thresh=v_thresh)


def _layer_operands(s: Tensor, ws, rs4: Tensor, ra4: Tensor, *, hd: int,
                    kv: int, with_tail: bool, with_mlp: bool):
    """Check the operands both layer kernels share and allocate the
    outputs.  Returns ``(weight triples, their pointers, dims, d_ff, mlp,
    outputs)``; the caller holds the triples until the launch is queued
    (some are made here, and freed memory is reused at once)."""
    t, b, d = s.shape
    h = ws[0][0].shape[1] // hd
    l = rs4.shape[-1]
    if h % kv:
        raise ValueError(f"fused decode layer: H={h} is not a multiple of "
                         f"KV={kv}")
    mlp = with_tail and with_mlp
    wq, wk, wv, wo, wi, wo2 = ws
    tri = [_norm_w(wq), _norm_w(wk), _norm_w(wv),
           _norm_w(wo) if with_tail else None,
           _norm_w(wi) if mlp else None, _norm_w(wo2) if mlp else None]
    dff = tri[4][0].shape[1] if mlp else 0
    smem = layer_smem_bytes(t, d, h, kv, hd, l, dff)
    if smem > SMEM_BUDGET:
        raise ValueError(
            f"fused decode layer: T={t} (d={d}, H={h}, KV={kv}, hd={hd}, "
            f"L={l}, d_ff={dff}) needs {smem} bytes of shared memory a "
            f"block, past the card's {SMEM_BUDGET}")
    dims = [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d), (d, dff),
            (dff, d)]
    for name, w, (di, do) in zip(("wq", "wk", "wv", "wo", "wi", "wo2"), tri,
                                 dims):
        if w is not None:
            KB.check_cuda(w[0], torch.int8, (di, do), name)
            KB.check_cuda(w[1], torch.float32, (do,), name + ".scale")
            KB.check_cuda(w[2], torch.float32, (do,), name + ".bias")
    KB.check_cuda(s, torch.float32, (t, b, d), "s")
    KB.check_cuda(rs4, torch.int32, (b, t, h, l), "rs")
    KB.check_cuda(ra4, torch.int32, (b, t, h, hd), "ra")
    ptrs = []
    for w in tri:
        ptrs += [0, 0, 0] if w is None else [x.data_ptr() for x in w]
    ds = d if with_tail else h * hd
    outs = (torch.empty((t, b, ds), dtype=torch.float32, device=s.device),
            torch.empty((t, b, kv, hd), dtype=torch.uint8, device=s.device),
            torch.empty((t, b, kv, hd), dtype=torch.uint8, device=s.device))
    return tri, ptrs, (t, b, d, h, kv, hd), dff, mlp, smem, outs


def fused_decode_layer_kernel(s: Tensor, sk: Tensor, sv: Tensor, pos: Tensor,
                              wq: Triple, wk: Triple, wv: Triple,
                              wo: Optional[Triple], wi: Optional[Triple],
                              wo2: Optional[Triple], rs4: Tensor, ra4: Tensor,
                              *, hd: int, with_tail: bool = True,
                              with_mlp: bool = True, beta: float = 0.5,
                              v_thresh: float = 1.0):
    """The layer step given its draws ``rs [B,T,H,L]``, ``ra [B,T,H,hd]``:
    the arguments of :func:`repro_torch.kernels.ref.decode_layer_ref`,
    which is what a CPU tensor runs.  On CUDA tensors it gathers each
    slot's new-token draw (:func:`_rs_at_pos`) and launches the kernel."""
    if not s.is_cuda:
        return KREF.decode_layer_ref(
            s, sk, sv, pos, wq, wk, wv, wo, wi, wo2, rs4, ra4, hd=hd,
            with_tail=with_tail, with_mlp=with_mlp, beta=beta,
            v_thresh=v_thresh)
    b, t, l, kv = sk.shape[:4]
    tri, ptrs, dims, dff, mlp, smem, outs = _layer_operands(
        s, (wq, wk, wv, wo, wi, wo2), rs4, ra4, hd=hd, kv=kv,
        with_tail=with_tail, with_mlp=with_mlp)
    KB.check_cuda(sk, torch.uint8, (b, t, l, kv, hd), "sk")
    KB.check_cuda(sv, torch.uint8, (b, t, l, kv, hd), "sv")
    rsp = _rs_at_pos(rs4, pos, pos < l).to(torch.int32).contiguous()
    t, b, d, h, kv, hd = dims
    err = _lib("launch_fused_decode_layer", 27, 10)(
        s.data_ptr(), sk.data_ptr(), sv.data_ptr(), rs4.data_ptr(),
        ra4.data_ptr(), rsp.data_ptr(), *ptrs, *(o.data_ptr() for o in outs),
        t, b, d, h, kv, hd, l, dff, int(with_tail), int(mlp), beta, v_thresh,
        smem, KB.stream_ptr(s))
    del tri  # held until the launch is queued
    KB.raise_on_error(err, "fused_decode_layer")
    KB.LAUNCHES["fused_decode_layer"] += 1
    return outs


def fused_decode_layer_paged(slot_keys: Tensor, s: Tensor, kpool: Tensor,
                             vpool: Tensor, page_table: Tensor, pos: Tensor,
                             write_pids: Tensor, wq: Triple, wk: Triple,
                             wv: Triple, wo: Optional[Triple] = None,
                             wi: Optional[Triple] = None,
                             wo2: Optional[Triple] = None,
                             h0: Union[int, Tensor] = 0, *, hd: int,
                             with_tail: bool = True, with_mlp: bool = True,
                             beta: float = 0.5, v_thresh: float = 1.0):
    """One fused spiking decoder layer step over a block-paged pool.

    As :func:`fused_decode_layer`, with the pre-scatter page pools
    ``kpool``/``vpool [P,T,KV,page_len,hd]`` uint8, ``page_table [B,MP]``
    int32 (page 0 the zero null page) and ``write_pids [B]``, the physical
    page each slot's new K/V train scatters into at ``pos % page_len``
    afterwards.  Draws at the logical length ``L = MP*page_len``, then runs
    :func:`fused_decode_layer_paged_kernel`."""
    t = s.shape[0]
    l = page_table.shape[1] * kpool.shape[3]
    h = wq[0].shape[1] // hd
    rs4, ra4 = draw_layer_prns(slot_keys, t, h, l, hd, h0)
    return fused_decode_layer_paged_kernel(
        s.to(torch.float32).contiguous(), kpool.contiguous(),
        vpool.contiguous(), page_table.to(torch.int32).contiguous(), pos,
        write_pids, wq, wk, wv, wo, wi, wo2, rs4, ra4, hd=hd,
        with_tail=with_tail, with_mlp=with_mlp, beta=beta, v_thresh=v_thresh)


def fused_decode_layer_paged_kernel(s: Tensor, kpool: Tensor, vpool: Tensor,
                                    page_table: Tensor, pos: Tensor,
                                    write_pids: Tensor, wq: Triple,
                                    wk: Triple, wv: Triple,
                                    wo: Optional[Triple],
                                    wi: Optional[Triple],
                                    wo2: Optional[Triple], rs4: Tensor,
                                    ra4: Tensor, *, hd: int,
                                    with_tail: bool = True,
                                    with_mlp: bool = True, beta: float = 0.5,
                                    v_thresh: float = 1.0):
    """The paged layer step given its draws ``rs [B,T,H,MP*page_len]``,
    ``ra [B,T,H,hd]``: the arguments of
    :func:`repro_torch.kernels.ref.decode_layer_paged_ref`, which is what a
    CPU tensor runs.  On CUDA tensors the new token's draw counts only
    where ``pos < L`` and ``table[b, pos // page_len] == write_pids[b]``;
    the kernel reads pages through the table and trusts its entries to lie
    in ``[0, P)``."""
    if not s.is_cuda:
        return KREF.decode_layer_paged_ref(
            s, kpool, vpool, page_table, pos, write_pids, wq, wk, wv, wo, wi,
            wo2, rs4, ra4, hd=hd, with_tail=with_tail, with_mlp=with_mlp,
            beta=beta, v_thresh=v_thresh)
    p, t, kv, page_len = kpool.shape[:4]
    b, mp = page_table.shape
    l = mp * page_len
    tri, ptrs, dims, dff, mlp, smem, outs = _layer_operands(
        s, (wq, wk, wv, wo, wi, wo2), rs4, ra4, hd=hd, kv=kv,
        with_tail=with_tail, with_mlp=with_mlp)
    KB.check_cuda(kpool, torch.uint8, (p, t, kv, page_len, hd), "kpool")
    KB.check_cuda(vpool, torch.uint8, (p, t, kv, page_len, hd), "vpool")
    KB.check_cuda(page_table, torch.int32, (b, mp), "page_table")
    col = (pos // page_len).clamp(0, mp - 1).to(torch.int64)
    reach = torch.take_along_dim(page_table, col[:, None], dim=1)[:, 0]
    rsp = _rs_at_pos(rs4, pos, (pos < l) & (reach == write_pids))
    rsp = rsp.to(torch.int32).contiguous()
    t, b, d, h, kv, hd = dims
    err = _lib("launch_fused_decode_layer_paged", 28, 11)(
        s.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
        page_table.data_ptr(), rs4.data_ptr(), ra4.data_ptr(),
        rsp.data_ptr(), *ptrs, *(o.data_ptr() for o in outs), t, b, d, h,
        kv, hd, page_len, mp, dff, int(with_tail), int(mlp), beta, v_thresh,
        smem, KB.stream_ptr(s))
    del tri  # held until the launch is queued
    KB.raise_on_error(err, "fused_decode_layer_paged")
    KB.LAUNCHES["fused_decode_layer_paged"] += 1
    return outs
