"""K3 and K9 launchers: one fused spiking decoder layer step over a dense
slot cache (K3) or a block-paged pool (K9) (``csrc/decode_fused.cu``).

Replace ``repro/kernels/decode_fused.py:fused_decode_layer`` and
``fused_decode_layer_paged``.  The kernel attends over the **pre-scatter**
cache (the row at each slot's ``pos`` is zero by the serving invariant)
and adds the new token's term on top, with its score draw ``rs[b, t, h,
pos[b]]``, which the kernel reads itself (``2**30``, never beaten, where
the write is masked: ``pos >= L``, or, paged, where the slot's table does
not show its write page at ``pos``, as for idle slots writing the trash
page); the caller scatters ``k_new``/``v_new`` afterwards.
:func:`layer_plan` owns the launch: one thread-block cluster of
:data:`CLUSTER` blocks a slot, their threads and
shared memory; the C launcher refuses any other plan, and a refused
launch raises (there is no other design to fall back to).  On a CPU
tensor a wrapper runs the plain version
(:func:`repro_torch.kernels.ref.decode_layer_ref` /
:func:`~repro_torch.kernels.ref.decode_layer_paged_ref`, scatter then
attend), which is the same function under that invariant.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels import ref as KREF

Tensor = torch.Tensor
Triple = Tuple[Tensor, Tensor, Optional[Tensor]]
_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)

def draw_layer_prns(slot_keys: Tensor, t: int, h: int, l: int, hd: int,
                    h0: Union[int, Tensor] = 0) -> Tuple[Tensor, Tensor]:
    """The unfused path's per-(slot, global head) draws (``r_s ~
    U{0..hd-1}``, ``r_a ~ U{0..L-1}``) as ``rs [B,T,H,L]``, ``ra
    [B,T,H,hd]``."""
    rs, ra = KOPS.draw_slot_decode_prns(slot_keys, t, h, l, hd, l, h0)
    b = slot_keys.shape[0]
    return rs.reshape(b, t, h, l), ra.reshape(b, t, h, hd)


CLUSTER = 8  # blocks a slot: the portable thread-block cluster size
THREADS = 256  # threads a block
_MAX_T = 8  # XPK_MAX_T: steps a linear's pass counts at once
_TILE_COLS = 4 * THREADS  # output columns a linear's pass takes
# the dynamic shared memory a block may take (the kernel has no static bytes)
SMEM_BUDGET = KB.SMEM_PER_BLOCK


class LayerPlan(NamedTuple):
    """One layer step's launch: ``cluster`` blocks a slot (a grid of ``B *
    cluster`` blocks), ``threads`` a block and ``smem`` bytes of dynamic
    shared memory a block."""
    cluster: int
    threads: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _share(n: int) -> int:
    """A cluster rank's share of ``n`` output columns, a multiple of 4."""
    return (_cdiv(n, CLUSTER) + 3) & ~3


def _align16(x: int) -> int:
    return (x + 15) & ~15


def layer_smem_segments(t: int, d: int, h: int, kv: int, hd: int, l: int,
                        dff: int) -> Tuple[int, ...]:
    """The bytes of each segment of ``csrc/decode_fused.cu:smem_layout``,
    in order: the int32 residual ``[T][d]`` and its int8 copy; this rank's
    query, new key and new value columns ``[T][share]``; for its ``R =
    ceil(T*H / CLUSTER)`` query rows the gathered q, k_new, v_new (``hd``
    bytes each), the packed query and key (``ceil(hd/32)`` words), the
    score words (``ceil(L/32)``), the int32 value counts, the new token's
    spike and the attention row; the whole attention train ``[T][H*hd]``,
    whose bytes the whole hidden train ``[T][d_ff]`` takes over; this
    rank's output and FFN hidden columns; the int32 partial counts of a
    linear's pass."""
    r, wd, wl = _cdiv(t * h, CLUSTER), _cdiv(hd, 32), _cdiv(l, 32)
    return (4 * t * d, t * d, t * _share(h * hd), t * _share(kv * hd),
            t * _share(kv * hd), r * hd, r * hd, r * hd, 4 * r * wd,
            4 * r * wd, 4 * r * wl, 4 * r * hd, 4 * r, r * hd,
            t * max(h * hd, dff), t * _share(d), t * _share(dff),
            4 * _TILE_COLS * min(t, _MAX_T))


@functools.lru_cache(maxsize=None)
def layer_smem_bytes(t: int, d: int, h: int, kv: int, hd: int, l: int,
                     dff: int) -> int:
    """Dynamic shared memory of one layer-step block: the segments of
    :func:`layer_smem_segments`, each 16-aligned.  The launcher refuses
    any number but its own layout's total."""
    total = 0
    for n in layer_smem_segments(t, d, h, kv, hd, l, dff):
        total = _align16(total + n)
    return total


def layer_plan(t: int, d: int, h: int, kv: int, hd: int, l: int,
               dff: int) -> LayerPlan:
    """The launch of a layer step at these widths (``dff`` 0 without the
    FFN tail): :data:`CLUSTER` blocks of :data:`THREADS` a slot and the
    shared memory of :func:`layer_smem_bytes`.  Raises ``ValueError``,
    naming T and the bytes, past the card's per-block budget."""
    smem = layer_smem_bytes(t, d, h, kv, hd, l, dff)
    if smem > SMEM_BUDGET:
        raise ValueError(
            f"fused decode layer: T={t} (d={d}, H={h}, KV={kv}, hd={hd}, "
            f"L={l}, d_ff={dff}) needs {smem} bytes of shared memory a "
            f"block, past the card's {SMEM_BUDGET}")
    return LayerPlan(CLUSTER, THREADS, smem)


def _norm_w(w: Triple) -> Triple:
    lv, sc, bi = w
    return (KB.conform(lv, torch.int8), KB.conform(sc, torch.float32),
            None if bi is None else KB.conform(bi, torch.float32))


# each launcher's pointer and int arguments, before (beta, v_thresh, smem,
# stream)
LAUNCHERS = {"launch_fused_decode_layer": (28, 12),
             "launch_fused_decode_layer_paged": (30, 13)}


def _lib(name: str):
    fn = getattr(KB.load("decode_fused"), name)
    if fn.argtypes is None:
        n_ptr, n_int = LAUNCHERS[name]
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
        KB.conform(s, torch.float32), sk.contiguous(), sv.contiguous(),
        pos, wq, wk, wv, wo, wi, wo2, rs4, ra4, hd=hd,
        with_tail=with_tail, with_mlp=with_mlp, beta=beta, v_thresh=v_thresh)


def _weight_ptrs(ws, dims, with_tail: bool, mlp: bool):
    """The 18 pointers of the six triples as the kernel reads them (0 for
    a null: no bias, or a triple the step does not use), each checked
    against ``dims`` (``(d_in, d_out)``), and the triples converted to get
    them, which the caller holds until the launch is queued."""
    use = (True, True, True, with_tail, mlp, mlp)
    tri = [_norm_w(w) if u else None for w, u in zip(ws, use)]
    ptrs = []
    for name, w, (di, do) in zip(("wq", "wk", "wv", "wo", "wi", "wo2"), tri,
                                 dims):
        if w is None:
            ptrs += [0, 0, 0]
            continue
        KB.check_cuda(w[0], torch.int8, (di, do), name)
        KB.check_cuda(w[1], torch.float32, (do,), name + ".scale")
        if w[2] is not None:
            KB.check_cuda(w[2], torch.float32, (do,), name + ".bias")
        ptrs += [w[0].data_ptr(), w[1].data_ptr(),
                 0 if w[2] is None else w[2].data_ptr()]
    return tri, ptrs


def _layer_operands(s: Tensor, ws, rs4: Tensor, ra4: Tensor, *, hd: int,
                    kv: int, with_tail: bool, with_mlp: bool):
    """Plan the launch, check the operands both layer kernels share and
    allocate the outputs.  Returns ``(converted weights, the weights'
    pointers, dims, d_ff, mlp, plan, outputs)``; the caller holds the
    converted weights until the launch is queued (freed memory is reused
    at once)."""
    t, b, d = s.shape
    h = ws[0][0].shape[1] // hd
    l = rs4.shape[-1]
    if h % kv:
        raise ValueError(f"fused decode layer: H={h} is not a multiple of "
                         f"KV={kv}")
    mlp = with_tail and with_mlp
    dff = ws[4][0].shape[1] if mlp else 0
    plan = layer_plan(t, d, h, kv, hd, l, dff)
    tri, ptrs = _weight_ptrs(
        ws, ((d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d), (d, dff),
             (dff, d)), with_tail, mlp)
    KB.check_cuda(s, torch.float32, (t, b, d), "s")
    KB.check_cuda(rs4, torch.int32, (b, t, h, l), "rs")
    KB.check_cuda(ra4, torch.int32, (b, t, h, hd), "ra")
    ds = d if with_tail else h * hd
    # k_new and v_new: the two halves of one allocation
    outs = (s.new_empty((t, b, ds)),
            *s.new_empty((2, t, b, kv, hd), dtype=torch.uint8).unbind(0))
    return tri, ptrs, (t, b, d, h, kv, hd), dff, mlp, plan, outs


def _placement_ptr(placement: Optional[Tensor], b: int, plan: LayerPlan):
    """The probe's pointer: 0, or ``placement`` int32 ``[B * cluster, 3]``
    on the card, which the launch fills with each block's SM, the size of
    its cluster and the cluster's index, as the hardware reports them."""
    if placement is None:
        return 0
    KB.check_cuda(placement, torch.int32, (b * plan.cluster, 3), "placement")
    return placement.data_ptr()


def _slot_ints(x: Tensor, dtype: torch.dtype, b: int, what: str) -> Tensor:
    """``pos`` (int32) or ``write_pids`` (int64) ``[B]`` as the kernel
    reads them (converted only where the caller's dtype differs)."""
    x = KB.conform(x, dtype)
    KB.check_cuda(x, dtype, (b,), what)
    return x


def fused_decode_layer_kernel(s: Tensor, sk: Tensor, sv: Tensor, pos: Tensor,
                              wq: Triple, wk: Triple, wv: Triple,
                              wo: Optional[Triple], wi: Optional[Triple],
                              wo2: Optional[Triple], rs4: Tensor, ra4: Tensor,
                              *, hd: int, with_tail: bool = True,
                              with_mlp: bool = True, beta: float = 0.5,
                              v_thresh: float = 1.0,
                              placement: Optional[Tensor] = None):
    """The layer step given its draws ``rs [B,T,H,L]``, ``ra [B,T,H,hd]``:
    the arguments of :func:`repro_torch.kernels.ref.decode_layer_ref`,
    which is what a CPU tensor runs.  On CUDA tensors it launches the
    kernel, which reads each slot's new-token draw itself; a
    ``placement`` tensor records where its blocks ran
    (:func:`_placement_ptr`)."""
    if not s.is_cuda:
        return KREF.decode_layer_ref(
            s, sk, sv, pos, wq, wk, wv, wo, wi, wo2, rs4, ra4, hd=hd,
            with_tail=with_tail, with_mlp=with_mlp, beta=beta,
            v_thresh=v_thresh)
    b, t, l, kv = sk.shape[:4]
    made, ptrs, dims, dff, mlp, plan, outs = _layer_operands(
        s, (wq, wk, wv, wo, wi, wo2), rs4, ra4, hd=hd, kv=kv,
        with_tail=with_tail, with_mlp=with_mlp)
    KB.check_cuda(sk, torch.uint8, (b, t, l, kv, hd), "sk")
    KB.check_cuda(sv, torch.uint8, (b, t, l, kv, hd), "sv")
    pos = _slot_ints(pos, torch.int32, b, "pos")
    t, b, d, h, kv, hd = dims
    err = _lib("launch_fused_decode_layer")(
        s.data_ptr(), sk.data_ptr(), sv.data_ptr(), pos.data_ptr(),
        rs4.data_ptr(), ra4.data_ptr(), *ptrs,
        *(o.data_ptr() for o in outs), _placement_ptr(placement, b, plan),
        t, b, d, h, kv, hd, l, dff,
        int(with_tail), int(mlp), plan.cluster, plan.threads, beta,
        v_thresh, plan.smem, KB.stream_ptr(s))
    del made  # held until the launch is queued
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
        KB.conform(s, torch.float32), kpool.contiguous(), vpool.contiguous(),
        KB.conform(page_table, torch.int32), pos,
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
                                    v_thresh: float = 1.0,
                                    placement: Optional[Tensor] = None):
    """The paged layer step given its draws ``rs [B,T,H,MP*page_len]``,
    ``ra [B,T,H,hd]``: the arguments of
    :func:`repro_torch.kernels.ref.decode_layer_paged_ref`, which is what a
    CPU tensor runs.  On CUDA tensors the kernel's new-token draw counts
    only where ``pos < L`` and ``table[b, pos // page_len] ==
    write_pids[b]``; it reads pages through the table and trusts its
    entries to lie in ``[0, P)``.  ``placement`` as for
    :func:`fused_decode_layer_kernel`."""
    if not s.is_cuda:
        return KREF.decode_layer_paged_ref(
            s, kpool, vpool, page_table, pos, write_pids, wq, wk, wv, wo, wi,
            wo2, rs4, ra4, hd=hd, with_tail=with_tail, with_mlp=with_mlp,
            beta=beta, v_thresh=v_thresh)
    p, t, kv, page_len = kpool.shape[:4]
    b, mp = page_table.shape
    made, ptrs, dims, dff, mlp, plan, outs = _layer_operands(
        s, (wq, wk, wv, wo, wi, wo2), rs4, ra4, hd=hd, kv=kv,
        with_tail=with_tail, with_mlp=with_mlp)
    KB.check_cuda(kpool, torch.uint8, (p, t, kv, page_len, hd), "kpool")
    KB.check_cuda(vpool, torch.uint8, (p, t, kv, page_len, hd), "vpool")
    KB.check_cuda(page_table, torch.int32, (b, mp), "page_table")
    pos = _slot_ints(pos, torch.int32, b, "pos")
    write_pids = _slot_ints(write_pids, torch.int64, b, "write_pids")
    t, b, d, h, kv, hd = dims
    err = _lib("launch_fused_decode_layer_paged")(
        s.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
        page_table.data_ptr(), write_pids.data_ptr(), pos.data_ptr(),
        rs4.data_ptr(), ra4.data_ptr(), *ptrs,
        *(o.data_ptr() for o in outs), _placement_ptr(placement, b, plan),
        t, b, d, h, kv, hd, page_len, mp, dff, int(with_tail), int(mlp),
        plan.cluster, plan.threads, beta, v_thresh, plan.smem,
        KB.stream_ptr(s))
    del made  # held until the launch is queued
    KB.raise_on_error(err, "fused_decode_layer_paged")
    KB.LAUNCHES["fused_decode_layer_paged"] += 1
    return outs
