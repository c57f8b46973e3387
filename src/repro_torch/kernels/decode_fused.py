"""K3 launcher: one fused spiking decoder layer step (``csrc/decode_fused.cu``).

Replaces ``repro/kernels/decode_fused.py:fused_decode_layer``.  The kernel
attends over the **pre-scatter** cache (the row at each slot's ``pos`` is
zero by the serving invariant) and adds the new token's term on top, with
its score draw ``rs[b, t, h, pos[b]]`` (``_INVALID_RS`` where the write is
masked, ``pos >= L``); the caller scatters ``k_new``/``v_new`` afterwards.
On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.decode_layer_ref`, scatter then attend),
which is the same function under that invariant.
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
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

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


def _norm_w(w: Triple) -> Triple:
    lv, sc, bi = w
    if bi is None:
        bi = torch.zeros_like(sc, dtype=torch.float32)
    return (lv.to(torch.int8).contiguous(), sc.to(torch.float32).contiguous(),
            bi.to(torch.float32).contiguous())


def _lib():
    fn = KB.load("decode_fused").launch_fused_decode_layer
    if fn.argtypes is None:
        fn.argtypes = [_P] * 27 + [_I] * 10 + [_F, _F, _P]
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
    t, b, d = s.shape
    l, kv = sk.shape[2], sk.shape[3]
    h = wq[0].shape[1] // hd
    if not s.is_cuda:
        return KREF.decode_layer_ref(
            s, sk, sv, pos, wq, wk, wv, wo, wi, wo2, rs4, ra4, hd=hd,
            with_tail=with_tail, with_mlp=with_mlp, beta=beta,
            v_thresh=v_thresh)
    if t > 8 or hd > 512:
        raise ValueError(f"fused_decode_layer: T={t} > 8 or hd={hd} > 512")
    rsp = _rs_at_pos(rs4, pos, pos < l).to(torch.int32).contiguous()
    mlp = with_tail and with_mlp
    tri = [_norm_w(wq), _norm_w(wk), _norm_w(wv),
           _norm_w(wo) if with_tail else None,
           _norm_w(wi) if mlp else None, _norm_w(wo2) if mlp else None]
    dff = tri[4][0].shape[1] if mlp else 0
    dims = [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d), (d, dff),
            (dff, d)]
    for name, w, (di, do) in zip(("wq", "wk", "wv", "wo", "wi", "wo2"), tri,
                                 dims):
        if w is not None:
            KB.check_cuda(w[0], torch.int8, (di, do), name)
            KB.check_cuda(w[1], torch.float32, (do,), name + ".scale")
            KB.check_cuda(w[2], torch.float32, (do,), name + ".bias")
    KB.check_cuda(s, torch.float32, (t, b, d), "s")
    KB.check_cuda(sk, torch.uint8, (b, t, l, kv, hd), "sk")
    KB.check_cuda(sv, torch.uint8, (b, t, l, kv, hd), "sv")
    KB.check_cuda(rs4, torch.int32, (b, t, h, l), "rs")
    KB.check_cuda(ra4, torch.int32, (b, t, h, hd), "ra")
    ds = d if with_tail else h * hd
    s_out = torch.empty((t, b, ds), dtype=torch.float32, device=s.device)
    k_new = torch.empty((t, b, kv, hd), dtype=torch.uint8, device=s.device)
    v_new = torch.empty_like(k_new)
    ptrs = []
    for w in tri:
        ptrs += [0, 0, 0] if w is None else [x.data_ptr() for x in w]
    err = _lib()(s.data_ptr(), sk.data_ptr(), sv.data_ptr(), rs4.data_ptr(),
                 ra4.data_ptr(), rsp.data_ptr(), *ptrs, s_out.data_ptr(),
                 k_new.data_ptr(), v_new.data_ptr(), t, b, d, h, kv, hd, l,
                 dff, int(with_tail), int(mlp), beta, v_thresh,
                 KB.stream_ptr(s))
    KB.raise_on_error(err, "fused_decode_layer")
    KB.LAUNCHES["fused_decode_layer"] += 1
    return s_out, k_new, v_new
