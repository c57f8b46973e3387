"""The port's engine: the Backend surface, two backends, and the engine
facade.

Twins of ``repro.engine``, restricted to what the ported paths call:

* :class:`Backend` -- ``spiking_linear``, ``ssa_attention`` and ``lif``
  (the paper models' primitives), ``decode_attention`` and
  ``decode_layer_fused`` (serving), each backend flagged
  ``differentiable`` and ``bit_exact``;
* ``"reference"`` (:class:`ReferenceBackend`) -- the float ops with
  straight-through surrogates (``repro.engine.ReferenceBackend``): the
  backend training runs under autograd, and the only one that simulates
  the analog crossbar (HWAT's noise, programmed state's read noise and
  ADC).  Plain PyTorch, no kernel; it has no ``decode_layer_fused``, so
  serving runs it unfused;
* ``"integer"`` (:class:`IntegerBackend`) -- the plain PyTorch versions
  (``kernels/ref.py``), mirroring ``repro.engine.IntegerBackend``: the
  bit-exact oracle;
* ``"cuda"`` (:class:`CudaBackend`) -- the hand-written Hopper kernels
  (K1 spiking linear, K5 crossbar counts, K8 SSA tile, K4 LIF, K2/K7 SSA
  decode row, K3/K9 fused layer), mirroring ``repro.engine.PallasBackend``.  Every wrapper
  runs its plain version on CPU tensors and its kernel on CUDA tensors,
  so this backend runs on either device and is bit-identical to
  ``"integer"``;
* :class:`MeteringBackend` -- wraps either and meters energy from the
  measured spike counts (``repro.engine.MeteringBackend``);
* :class:`XpikeformerEngine` -- ``from_config`` (the paper's spiking ViT
  and GPT of ``SPIKING_ARCHS`` first, then the LM-stack registry, as the
  reference resolves names), ``init``, the programmed-PCM lifecycle
  (``program``, ``drift_to``, ``recalibrate``), ``forward`` (tasks
  ``"vit"``, ``"gpt"`` and ``"lm"``, optionally metered), ``classify``,
  ``detect_symbols`` (tasks ``"vit"``/``"gpt"``),
  ``serve`` and ``generate`` over the dense or paged scheduler, optionally
  under a :class:`repro_torch.aimc_device.DriftPolicy`, and ``executor``
  for a ``(data, model)`` mesh (task ``"lm"``).

A linear param leaf is a float weight ``[d_in, d_out]``, a ``{"w", "b"}``
dict, programmed PCM state (an :class:`repro_torch.aimc_device.
AIMCDeviceState`, bare or as ``{"hw", "b"}``), or a pre-quantised
``{"levels", "scale", "b"}`` dict (what :func:`repro_torch.models.
transformer.quantize_params` makes once per scheduler, where the
reference re-quantises inside every jitted step).  A programmed leaf
executes its digital image: the drifted int8 ``levels_t`` and the
per-column ``eff_scale`` that ``drift_to``/``recalibrate`` folded.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Protocol, Union

import torch

from repro_torch import aimc_device as AD
from repro_torch import prng
from repro_torch.core import aimc as AM
from repro_torch.core import spikes as SP
from repro_torch.core import ssa as SSA
from repro_torch.device import resolve_device
from repro_torch.kernels import decode_fused as KFD
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels import ref as KREF
from repro_torch.kernels.plan import AttnSpec, KVView

Tensor = torch.Tensor


class Backend(Protocol):
    """A compute substrate for the spiking primitives."""

    name: str

    differentiable: bool
    bit_exact: bool

    def spiking_linear(self, p: Any, spikes: Tensor, *,
                       key: Optional[Tensor] = None, sim: Any = None,
                       part: Optional[str] = None,
                       group: Optional[str] = None) -> Tensor:
        """``LIF(W s^t + b)`` over a ``[T, ..., d_in]`` spike train.
        ``key`` and ``sim`` (an :class:`repro_torch.core.
        spiking_transformer.AIMCSim`) are the analog simulation's, which
        only the reference backend runs; the digital backends ignore them.
        ``part`` (``"col"``/``"row"``) and ``group`` (the block part,
        ``"mixer"`` or ``"mlp"``, whose split decides whether a row
        linear sums over the model group) are the tensor-parallel hints a
        mesh backend reads (:mod:`repro_torch.distributed`); one device
        ignores them."""
        ...

    def ssa_attention(self, key: Tensor, q: Tensor, k: Tensor, v: Tensor, *,
                      causal: bool = False, b0: int = 0, h0: int = 0,
                      batch: Optional[int] = None,
                      heads: Optional[int] = None) -> Tensor:
        """Stochastic spiking attention over ``[T,B,H,N,d]`` spike trains,
        comparator integers drawn from ``key`` over a ``[T, batch, heads]``
        grid of tiles of which these are the block from batch row ``b0``
        and head ``h0`` (a mesh rank's share; the defaults are the whole
        grid)."""
        ...

    def lif(self, currents: Tensor, *, beta: float = 0.5,
            v_thresh: float = 1.0) -> Tensor:
        """The LIF neuron over a ``[T, ...]`` current sequence."""
        ...

    def decode_attention(self, view: KVView, q: Tensor, spec: AttnSpec, *,
                         slot_keys: Tensor) -> Tensor:
        """One-query SSA decode ``q [T,B,H,1,d]`` against a dense view
        ``k``/``v [T,B,H,L,d]`` or a paged view (pools ``[P,T,KV,page_len,
        d]`` + page table); per-slot keys ``[B, 2]``."""
        ...

    def decode_layer_fused(self, slot_keys, s, view, pos, wq, wk, wv,
                           wo=None, wi=None, wo2=None, *, hd, h0=0,
                           with_tail=True, with_mlp=True, write_pids=None):
        """One decoder layer step over the pre-scatter dense cache or page
        pool (paged: ``write_pids [B]`` names each slot's write page).
        ``h0`` is the global index of the first query head (a head-parallel
        rank's offset); ``with_tail=False`` stops after the attention and
        returns its train ``[T,B,H*hd]`` first."""
        ...


_A12 = ("ROADMAP A12 (legacy {'hw': dict} leaves of "
        "core/aimc.py:program_weights)")


def _linear_parts(p: Any) -> Dict[str, Any]:
    if isinstance(p, AD.AIMCDeviceState):
        return {"hw": p, "b": None}
    return p if isinstance(p, dict) else {"w": p, "b": None}


def _levels_scale(p: Dict[str, Any]):
    """Integer conductance levels (int8) + per-column scale of a linear
    leaf: programmed state gives its digital image (``levels_t``,
    ``eff_scale``), pre-quantised leaves pass through, float weights
    quantise via :func:`repro_torch.aimc_device.quantize_weights`."""
    if "hw" in p:
        hw = p["hw"]
        if not isinstance(hw, AD.AIMCDeviceState):
            raise NotImplementedError(
                f"programmed {{'hw': dict}} leaves are not ported: {_A12}")
        return hw.levels_t, hw.eff_scale
    if "levels" in p:
        return p["levels"].to(torch.int8), p["scale"]
    levels, scale = AD.quantize_weights(p["w"])
    return levels.to(torch.int8), scale


def _w_triple(p: Any):
    """Linear param leaf -> the fused kernel's (levels, scale, bias)."""
    parts = _linear_parts(p)
    levels, scale = _levels_scale(parts)
    return (levels, scale, parts.get("b"))


def _triples(*ws):
    """Linear leaves (or ``None``) -> the fused kernel's weight triples."""
    return [None if w is None else _w_triple(w) for w in ws]


def _gather_paged_kv(q: Tensor, kpool: Tensor, vpool: Tensor,
                     page_table: Tensor):
    """Dense ``[T,B,H,L,d]`` K/V views of a paged pool, GQA-repeated to
    ``q``'s heads: the float backend's paged decode reads the dense view."""
    h, kv = q.shape[2], kpool.shape[2]
    k = KOPS.gather_kv_pages(kpool, page_table)  # [T, B, KV, L, d]
    v = KOPS.gather_kv_pages(vpool, page_table)
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    return k, v


def _flatten_time(spikes: Tensor):
    """``[T, *lead, d_in] -> ([T, M, d_in], unflatten)``."""
    t, lead, d_in = spikes.shape[0], spikes.shape[1:-1], spikes.shape[-1]

    def unflatten(out: Tensor) -> Tensor:
        return out.reshape((t,) + tuple(lead) + (out.shape[-1],))

    return spikes.reshape(t, -1, d_in), unflatten


class ReferenceBackend:
    """Float ops with straight-through Bernoulli/Heaviside surrogates
    (``repro.engine.ReferenceBackend``): the backend autograd trains
    through, and the only one that applies the AIMC analog simulation
    (``wmode="hwat"``'s noisy weights; programmed state's drift, read noise
    and ADC).  Spikes come out as float tensors of the input's dtype."""

    name = "reference"
    differentiable = True
    bit_exact = False

    def ssa_attention(self, key, q, k, v, *, causal=False, b0=0, h0=0,
                      batch=None, heads=None):
        """The float SSA; ``b0``/``h0`` of a ``heads`` grid: a mesh rank's
        rows and heads, drawing the whole tile's comparators there."""
        return SSA.ssa_attention(key, q, k, v, causal=causal, b0=b0, h0=h0,
                                 heads=heads)

    def lif(self, currents, *, beta=0.5, v_thresh=1.0):
        return SP.lif(currents, SP.LIFParams(beta=beta, v_thresh=v_thresh))

    def decode_attention(self, view, q, spec, *, slot_keys):
        """One query row per (slot, head): keys ``fold_in(slot_key, h0 +
        h)`` split in two, the score and output uniforms drawn from them;
        a paged view is gathered to the dense one."""
        if view.paged:
            k, v = _gather_paged_kv(q, view.k, view.v, view.page_table)
        else:
            k, v = view.k, view.v
        t, b, h, n1, d = q.shape
        heads = torch.arange(h, device=slot_keys.device) + spec.h0
        kk = prng.split(prng.fold_in(slot_keys[:, None, :], heads))  # [B,H,2,2]
        qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
        counts_s = torch.einsum("tbhnd,tbhld->tbhnl", qf, kf)
        p_s = AM.mul_reciprocal(counts_s, d)
        u_s = prng.uniform(kk[:, :, 0], (t, n1, k.shape[3])).permute(
            2, 0, 1, 3, 4)
        s = SP.bernoulli_st(p_s, u_s)
        counts_a = torch.einsum("tbhnl,tbhld->tbhnd", s, vf)
        p_a = SP.clip01(AM.mul_reciprocal(counts_a, spec.i_max))
        u_a = prng.uniform(kk[:, :, 1], (t, n1, d)).permute(2, 0, 1, 3, 4)
        return SP.bernoulli_st(p_a, u_a)

    def spiking_linear(self, p, spikes, *, key=None, sim=None, part=None,
                       group=None):
        """``LIF(pre + b)`` with the float LIF: ``pre = s^t @ w`` for float
        weights (``sim.wmode == "hwat"``: HWAT's noisy weights from
        ``key``); for programmed state the analog crossbar at the state's
        clock, with the same read noise (``key``) at every timestep, as the
        reference's ``vmap`` over ``T`` draws it."""
        from repro_torch.core.spiking_transformer import IDEAL_SIM

        sim = sim or IDEAL_SIM
        p = _linear_parts(p)
        if "hw" in p:
            hw = p["hw"]
            if not isinstance(hw, AD.AIMCDeviceState):
                raise NotImplementedError(
                    f"programmed {{'hw': dict}} leaves are not ported: {_A12}")
            pre = torch.stack([AD.analog_matmul(key, zt, hw, sim.cfg)
                               for zt in spikes])
        else:
            w = p["w"]
            if sim.wmode == "hwat":
                if key is None:
                    raise ValueError("wmode='hwat' draws its noise from a key")
                w = AM.hwat_weights(key, w, sim.cfg)
            pre = torch.matmul(spikes, w)
        if p.get("b") is not None:
            pre = pre + p["b"]
        return SP.lif(pre)


class IntegerBackend:
    """The bit-exact oracle: plain PyTorch versions of every kernel, with
    the comparator draws of the reference's integer backend."""

    name = "integer"
    differentiable = False
    bit_exact = True

    def ssa_attention(self, key, q, k, v, *, causal=False, **tile):
        return KREF.ssa_attention_keyed_ref(q, k, v, key, causal=causal,
                                            **tile)

    def lif(self, currents, *, beta=0.5, v_thresh=1.0):
        t = currents.shape[0]
        flat = currents.to(torch.float32).reshape(t, -1)
        out = KREF.lif_ref(flat, beta=beta, v_thresh=v_thresh)
        return out.reshape(currents.shape)

    def decode_attention(self, view, q, spec, *, slot_keys):
        if view.paged:  # the dense layout's streams: paged equals dense
            return KREF.ssa_decode_paged_keyed_ref(
                q, view.k, view.v, view.page_table, slot_keys, spec.h0,
                i_max=spec.i_max)
        return KREF.ssa_decode_keyed_ref(q, view.k, view.v, slot_keys,
                                         spec.h0, i_max=spec.i_max)

    def decode_layer_fused(self, slot_keys, s, view, pos, wq, wk, wv,
                           wo=None, wi=None, wo2=None, *, hd, h0=0,
                           with_tail=True, with_mlp=True, write_pids=None):
        ws = _triples(wq, wk, wv, wo, wi, wo2)
        h = ws[0][0].shape[1] // hd
        kw = dict(hd=hd, with_tail=with_tail, with_mlp=with_mlp)
        if view.paged:
            l = view.page_table.shape[1] * view.k.shape[3]
            rs4, ra4 = KFD.draw_layer_prns(slot_keys, s.shape[0], h, l, hd, h0)
            return KREF.decode_layer_paged_ref(
                s, view.k, view.v, view.page_table, pos, write_pids, *ws,
                rs4, ra4, **kw)
        rs4, ra4 = KFD.draw_layer_prns(slot_keys, s.shape[0], h,
                                       view.k.shape[2], hd, h0)
        return KREF.decode_layer_ref(s, view.k, view.v, pos, *ws, rs4, ra4,
                                     **kw)

    def crossbar_counts(self, spikes, levels):
        """Exact integer counts ``[T,M,d_out]`` (f32) of ``[T,M,d_in]``
        spikes over int8 ``levels``: a spiking linear before its scale,
        bias and LIF (a row-parallel rank's share, summed over ranks)."""
        return KREF.aimc_counts_ref(spikes, levels)

    def counts_lif(self, counts, scale, bias, *, beta=0.5, v_thresh=1.0):
        """A row-parallel linear's epilogue on the summed counts ``[T,M,N]``:
        ``LIF(counts * scale + bias)`` (two roundings) -> uint8."""
        return KREF.lif_counts_ref(counts, scale, bias, beta=beta,
                                   v_thresh=v_thresh)

    def spiking_linear(self, p, spikes, *, key=None, sim=None, part=None,
                       group=None):
        p = _linear_parts(p)
        levels, scale = _levels_scale(p)
        flat, unflatten = _flatten_time(spikes)
        out = KREF.aimc_spiking_linear_ref(flat.to(torch.float32), levels,
                                           scale, p.get("b"))
        return unflatten(out)


class CudaBackend:
    """The hand-written Hopper kernels: K1 (spiking linear), K5 (crossbar
    counts), K8 (SSA tile; its keyed entry draws its comparators in the
    kernel and reads and writes the heads in place), K4 (LIF; with
    ``counts_lif``, a row-parallel linear's scale, bias and LIF in one
    launch), K2/K7 (SSA decode row, dense/paged; both draw their
    comparators in the kernel),
    K3/K9 (fused decoder layer, dense/paged).  A paged view goes to the
    paged kernels, which read the pools through the page table.
    Bit-exact vs :class:`IntegerBackend`."""

    name = "cuda"
    differentiable = False
    bit_exact = True

    def ssa_attention(self, key, q, k, v, *, causal=False, **tile):
        return KOPS.ssa_attention_packed(q, k, v, key, causal=causal, **tile)

    def lif(self, currents, *, beta=0.5, v_thresh=1.0):
        return KOPS.lif_fused(currents, beta=beta, v_thresh=v_thresh)

    def decode_attention(self, view, q, spec, *, slot_keys):
        if view.paged:
            return KOPS.ssa_attention_decode_paged_packed(
                q, view.k, view.v, view.page_table, slot_keys, spec.h0,
                i_max=spec.i_max, pos=view.pos)
        return KOPS.ssa_attention_decode_packed(
            q, view.k, view.v, slot_keys, spec.h0, i_max=spec.i_max,
            pos=view.pos)

    def decode_layer_fused(self, slot_keys, s, view, pos, wq, wk, wv,
                           wo=None, wi=None, wo2=None, *, hd, h0=0,
                           with_tail=True, with_mlp=True, write_pids=None):
        kw = dict(hd=hd, with_tail=with_tail, with_mlp=with_mlp)
        if view.paged:
            return KFD.fused_decode_layer_paged(
                slot_keys, s, view.k, view.v, view.page_table, pos,
                write_pids, *_triples(wq, wk, wv, wo, wi, wo2), h0, **kw)
        return KFD.fused_decode_layer(
            slot_keys, s, view.k, view.v, pos,
            *_triples(wq, wk, wv, wo, wi, wo2), h0, **kw)

    def crossbar_counts(self, spikes, levels):
        return KOPS.aimc_matmul_counts(spikes, levels)

    def counts_lif(self, counts, scale, bias, *, beta=0.5, v_thresh=1.0):
        return KOPS.lif_counts_fused(counts, scale, bias, beta=beta,
                                     v_thresh=v_thresh)

    def spiking_linear(self, p, spikes, *, key=None, sim=None, part=None,
                       group=None):
        p = _linear_parts(p)
        levels, scale = _levels_scale(p)
        flat, unflatten = _flatten_time(spikes)
        out = KOPS.aimc_spiking_linear(flat.contiguous(), levels, scale,
                                       p.get("b"))
        return unflatten(out)


class MeteringBackend:
    """Wraps a backend and meters energy from **measured** spike counts
    (``repro.engine.MeteringBackend``): every primitive call of a paper
    forward (``spiking_linear``, ``ssa_attention``) converts its operand
    and output spike events to picojoules with the Table-II op energies
    (:mod:`repro_torch.energy.model`) into :attr:`report`.  Counting reads
    each count back to the host, so metering is for one forward at a time
    (``engine.forward(..., metering=True)``); serving books its energy in
    the scheduler.  Counts are exact (summed in float64); the reference
    sums in float32, which is exact below 2**24 events a call."""

    def __init__(self, inner: Backend):
        from repro_torch.energy import model as EM

        self.inner = inner
        self.report = EM.EnergyReport()
        self.name = f"metered[{inner.name}]"
        self.differentiable = False
        self.bit_exact = inner.bit_exact

    @staticmethod
    def _count(x: Tensor) -> float:
        return float(torch.sum(x, dtype=torch.float64))

    def ssa_attention(self, key, q, k, v, *, causal=False, **tile):
        from repro_torch.energy import model as EM

        out = self.inner.ssa_attention(key, q, k, v, causal=causal, **tile)
        t, b, h, n, d = q.shape
        qs, ks, vs = self._count(q), self._count(k), self._count(v)
        e = EM.meter_ssa(t, b * h, n, n, d, qs / q.numel(), ks / k.numel(),
                         vs / v.numel())
        self.report.ssa_pj += e["ssa"]
        self.report.spikes_in += qs + ks + vs
        self.report.spikes_out += self._count(out)
        self.report.calls += 1
        return out

    def spiking_linear(self, p, spikes, *, key=None, sim=None, part=None,
                       group=None):
        from repro_torch.energy import model as EM

        out = self.inner.spiking_linear(p, spikes, key=key, sim=sim,
                                        part=part, group=group)
        t = spikes.shape[0]
        d_in, d_out = spikes.shape[-1], out.shape[-1]
        tokens = int(spikes.numel() // (t * d_in))
        ins = self._count(spikes)
        e = EM.meter_spiking_linear(t, tokens, d_in, d_out, ins)
        self.report.aimc_pj += e["aimc"]
        self.report.lif_pj += e["lif"]
        self.report.spikes_in += ins
        self.report.spikes_out += self._count(out)
        self.report.calls += 1
        return out


BACKENDS = {"reference": ReferenceBackend, "integer": IntegerBackend,
            "cuda": CudaBackend}


def get_backend(spec: Union[str, Backend, None]) -> Backend:
    """Resolve a backend name (default ``"cuda"``) or pass one through."""
    if spec is None:
        return CudaBackend()
    if isinstance(spec, str):
        if spec not in BACKENDS:
            raise KeyError(f"unknown backend {spec!r}; known: {sorted(BACKENDS)}")
        return BACKENDS[spec]()
    return spec


@dataclasses.dataclass
class XpikeformerEngine:
    """One handle over a model of the paper: the spiking ViT (``task=
    "vit"``) or GPT (``"gpt"``) of ``SPIKING_ARCHS``, run by
    :meth:`forward`, or an arch of the LM stack (``"lm"``: a spiking GPT or
    a float arch of the registry), run by :meth:`forward` and served by
    :meth:`serve` and :meth:`generate`.  Holds config, backend, device and params, and the
    programmed-PCM settings (``wmode``: ``"ideal"`` float weights,
    ``"hwat"`` their noisy training forward or ``"hw"`` programmed state;
    ``aimc_cfg``; the device clock ``t_seconds``)."""

    cfg: Any  # SpikingConfig (vit, gpt) or ModelConfig (lm)
    backend: Backend
    device: torch.device
    params: Any = None
    task: str = "lm"  # vit | gpt | lm
    wmode: str = "ideal"  # ideal | hwat | hw
    aimc_cfg: Any = dataclasses.field(default_factory=AD.AIMCConfig)
    t_seconds: float = 0.0
    _schedulers: Dict[Any, Any] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @classmethod
    def from_config(cls, name_or_cfg, *, task: Optional[str] = None,
                    backend: Union[str, Backend] = "cuda",
                    wmode: str = "ideal", aimc_cfg=None,
                    t_seconds: float = 0.0, reduced: bool = False,
                    device: Union[str, torch.device] = "cuda"
                    ) -> "XpikeformerEngine":
        """Build from an arch name or a config, resolved as the reference
        resolves it: a name of ``SPIKING_ARCHS`` is the paper model unless
        ``task="lm"``, else a name of the LM-stack registry (``reduced=True``
        for its CPU smoke size); a :class:`ModelConfig` is ``"lm"`` and a
        :class:`SpikingConfig` is ``"gpt"`` when it has ``input_dim``, else
        ``"vit"``.  ``aimc_cfg`` (Table II by default) and ``t_seconds``
        (the device age :meth:`program` starts at) set the PCM lifecycle;
        ``wmode="hwat"`` (hardware-aware training's noisy forward) runs on
        the reference backend, which alone simulates the analog weights."""
        from repro_torch.configs import ModelConfig, registry
        from repro_torch.configs.xpikeformer import SPIKING_ARCHS
        from repro_torch.core import spiking_transformer as ST

        if isinstance(name_or_cfg, str):
            if name_or_cfg in SPIKING_ARCHS and task != "lm":
                task_, cfg = SPIKING_ARCHS[name_or_cfg]
                task = task or task_
            elif name_or_cfg in registry.ARCHS:
                cfg = (registry.reduced_config(name_or_cfg) if reduced
                       else registry.get_config(name_or_cfg))
                task = task or "lm"
            else:
                raise KeyError(
                    f"unknown engine arch {name_or_cfg!r}; known: "
                    f"{sorted(SPIKING_ARCHS)} + registry {sorted(registry.ARCHS)}")
        elif isinstance(name_or_cfg, ModelConfig):
            cfg = name_or_cfg
            task = task or "lm"
        else:
            cfg = name_or_cfg
            task = task or ("gpt" if cfg.input_dim > 0 else "vit")
        if task in ("vit", "gpt"):
            ST.check_ported(cfg, wmode)
        else:
            ST.check_wmode(wmode)
        return cls(cfg=cfg, backend=get_backend(backend),
                   device=resolve_device(device), task=task, wmode=wmode,
                   aimc_cfg=aimc_cfg or AD.AIMCConfig(),
                   t_seconds=float(t_seconds))

    def init(self, seed: int = 0):
        """Random weights from ``seed`` (``torch.Generator``)."""
        if self.task == "lm":
            from repro_torch.models import transformer as T

            self.params = T.init_params(self.cfg, seed, self.device)
        else:
            from repro_torch.core import spiking_transformer as ST

            init = ST.init_vit if self.task == "vit" else ST.init_gpt
            self.params = init(self.cfg, seed, self.device)
        return self.params

    @property
    def sim(self):
        """The paper models' :class:`repro_torch.core.spiking_transformer.
        AIMCSim`: the weight mode and the Table-II configuration."""
        from repro_torch.core.spiking_transformer import AIMCSim

        return AIMCSim(wmode=self.wmode, cfg=self.aimc_cfg)

    # -- the programmed-PCM lifecycle ------------------------------------

    def program(self, key: Tensor, params: Any = None):
        """Program the float weights onto simulated PCM crossbars (every
        ``{"w", "b"}`` linear of a paper model; the LM stack's attention
        and MLP weights) and switch to ``wmode="hw"``.  One-shot: a tree
        that already holds programmed state raises.  ``key`` is a key of
        the threefry twin; the same key programs the reference's state up
        to the ``erfinv`` float boundary of the normal draws.  An engine
        built with ``t_seconds > 0`` drifts the new state there."""
        from repro_torch.core import spiking_transformer as ST

        params = self.params if params is None else params
        if params is None:
            raise ValueError("call init() first or pass params")
        if AD.is_programmed(params):
            raise ValueError(
                "engine.program(): params already hold programmed PCM state; "
                "programming is one-shot -- use drift_to()/recalibrate() to "
                "advance the device lifecycle")
        key = key.to(self.device)
        if self.task == "lm":
            self.params = AD.program_lm_tree(key, params, self.aimc_cfg)
        else:
            self.params = ST.program_model(key, params, self.aimc_cfg)
        self.wmode = "hw"
        if self.t_seconds > 0:
            self.params = AD.drift_tree(self.params, self.t_seconds,
                                        self.aimc_cfg)
        return self.params

    @staticmethod
    def _require_device_state(params) -> None:
        if not AD.has_device_state(params):
            raise ValueError(
                "the drift lifecycle needs AIMCDeviceState leaves, which "
                "carry the device clock -- call engine.program() first")

    def drift_to(self, t_seconds: float, params: Any = None):
        """Move the programmed device clock to ``t_seconds`` and refresh
        every leaf's int8 image (K6, one launch per leaf)."""
        params = self.params if params is None else params
        self._require_device_state(params)
        self.params = AD.drift_tree(params, float(t_seconds), self.aimc_cfg)
        self.t_seconds = float(t_seconds)
        return self.params

    def recalibrate(self, params: Any = None):
        """Global drift compensation (GDC, §V-B) at the current clock: fold
        each crossbar's measured gain into its per-column scale."""
        params = self.params if params is None else params
        self._require_device_state(params)
        self.params = AD.recalibrate_tree(params, self.aimc_cfg)
        return self.params

    # -- forward ---------------------------------------------------------

    def forward(self, x: Tensor, rng: Optional[Tensor] = None,
                params: Any = None, *, metering: bool = False):
        """Images ``[B,H,W,C]`` -> class logits ``[B, classes]`` (vit),
        feature sequences ``[B,L,input_dim]`` -> per-token symbol logits
        ``[B,L,vocab]`` (gpt), or token ids ``[B,S]`` -> next-token logits
        ``[B,S,V]`` (lm: :func:`repro_torch.models.transformer.forward`;
        a frontend arch takes its embeddings ``[B,S,frontend_dim]``).
        ``rng`` is a key of the threefry twin
        (:func:`repro_torch.prng.PRNGKey`): the same key draws the
        reference's spikes (a float LM stack draws nothing and needs
        none).  With ``metering=True`` the primitives run
        through a :class:`MeteringBackend` and the call returns ``(logits,
        report)``, a :class:`repro_torch.energy.model.EnergyReport`."""
        params = self.params if params is None else params
        if params is None:
            raise ValueError("call init() first or pass params")
        backend = MeteringBackend(self.backend) if metering else self.backend
        if self.task == "lm":
            from repro_torch.models import transformer as T

            name = "embeddings" if self.cfg.frontend != "none" else "tokens"
            logits, _ = T.forward(params, {name: x.to(self.device)},
                                  self.cfg, rng=None if rng is None
                                  else rng.to(self.device), backend=backend)
        else:
            from repro_torch.core import spiking_transformer as ST

            if rng is None:
                raise ValueError("the paper models' forward needs an rng")
            fwd = ST.vit_forward if self.task == "vit" else ST.gpt_forward
            logits = fwd(params, x.to(self.device, torch.float32), self.cfg,
                         rng.to(self.device), backend=backend, sim=self.sim)
        if metering:
            return logits, backend.report
        return logits

    def classify(self, images: Tensor, rng: Tensor, params: Any = None
                 ) -> Tensor:
        """``[B,H,W,C]`` images -> ``[B]`` predicted class labels."""
        if self.task != "vit":
            raise ValueError("classify() is the ViT task")
        return torch.argmax(self.forward(images, rng, params), dim=-1)

    def detect_symbols(self, feats: Tensor, rng: Tensor, params: Any = None
                       ) -> Tensor:
        """``[B,L,feat]`` received-signal features -> ``[B,L]`` symbols."""
        if self.task != "gpt":
            raise ValueError("detect_symbols() is the GPT / ICL task")
        return torch.argmax(self.forward(feats, rng, params), dim=-1)

    # -- serving (task="lm") ---------------------------------------------

    def scheduler(self, *, slots: int = 4, cache_len: int = 64,
                  decode_kernel: str = "auto", paged: bool = False,
                  page_len: int = 8, n_pages: Optional[int] = None,
                  drift=None, moe_impl: Optional[str] = None):
        """A :class:`repro_torch.serving.BatchScheduler`, dense or (with
        ``paged=True``) over a block-paged pool of ``n_pages`` pages of
        ``page_len`` tokens; cached per geometry, reset on reuse and given
        the engine's current params (the device clock is read from them,
        never reset).  ``drift`` (a :class:`repro_torch.aimc_device.
        DriftPolicy`) runs the PCM lifecycle on programmed params;
        ``moe_impl`` a MoE stack's path (the scheduler's default when
        ``None``), part of the cache key."""
        from repro_torch.serving import BatchScheduler

        if self.task != "lm":
            raise ValueError("serving drives the LM stack (task='lm')")
        if self.params is None:
            raise ValueError("call init() first or set params")
        key = (slots, cache_len, moe_impl, decode_kernel, paged) + (
            (page_len, n_pages) if paged else ())
        sch = self._schedulers.get(key)
        if sch is not None:
            sch.reset()
            if sch.source_params is not self.params:
                sch.set_params(self.params)
            sch.drift = drift
            return sch
        sch = BatchScheduler(self.params, self.cfg, self.backend, slots=slots,
                             cache_len=cache_len, decode_kernel=decode_kernel,
                             paged=paged, page_len=page_len, n_pages=n_pages,
                             device=self.device, drift=drift,
                             moe_impl=moe_impl)
        self._schedulers[key] = sch
        return sch

    def serve(self, prompts, max_new: int = 16, *, slots: int = 4,
              cache_len: int = 64, seed: int = 0, decode_kernel: str = "auto",
              paged: bool = False, page_len: int = 8,
              n_pages: Optional[int] = None, drift=None,
              moe_impl: Optional[str] = None):
        """Continuous-batching serve: prompts -> (outputs, ServeStats);
        request ``i`` draws from the PRN stream ``seed + i``.  Paged and
        dense serving give the same tokens.  Under a ``drift`` policy the
        engine adopts the aged (and recalibrated) device state afterwards,
        so a later call continues from the aged clock."""
        sch = self.scheduler(slots=slots, cache_len=cache_len,
                             decode_kernel=decode_kernel, paged=paged,
                             page_len=page_len, n_pages=n_pages, drift=drift,
                             moe_impl=moe_impl)
        rids = [sch.submit(p, max_new, seed=seed + i)
                for i, p in enumerate(prompts)]
        outs = sch.run()
        if sch.programmed:
            self.params = sch.source_params
        return [outs[r] for r in rids], sch.stats

    def generate(self, prompts, max_new: int = 16, **kwargs):
        """Greedy batch decode: prompts -> generated token-id lists."""
        outs, _ = self.serve(prompts, max_new, **kwargs)
        return outs

    # -- distributed (mesh) serving (task="lm") ---------------------------

    def executor(self, mesh):
        """A :class:`repro_torch.distributed.Executor` of this engine's
        params on ``mesh`` (a :class:`repro_torch.launch.mesh.ServingMesh`
        of the calling rank): decode slots data-parallel, the spiking
        linears and SSA heads tensor-parallel, a float MoE stack's experts
        expert-parallel.  Called on every rank of the mesh (one process
        each, :func:`repro_torch.launch.mesh.run_ranks`); a spiking stack's
        tokens equal this engine's on one device, bit for bit.  The mesh
        rank's device must be this engine's."""
        from repro_torch.distributed import Executor

        if self.task != "lm":
            raise ValueError("the mesh executor serves the LM stack "
                             "(task='lm')")
        if self.params is None:
            raise ValueError("call init() first or set params")
        dev, mine = mesh.device, self.device
        if dev.type != mine.type or (
                None not in (dev.index, mine.index) and dev.index != mine.index):
            raise ValueError(f"the mesh rank runs on {dev}, this engine on "
                             f"{self.device}")
        return Executor(self.params, self.cfg, self.backend, mesh)
