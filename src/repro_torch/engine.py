"""The port's engine: the Backend surface of the serving path, two backends,
and a thin engine facade.

Twins of ``repro.engine``, restricted to what dense spiking serving calls:

* :class:`Backend` -- ``spiking_linear``, ``decode_attention`` and
  ``decode_layer_fused``;
* ``"integer"`` (:class:`IntegerBackend`) -- the plain PyTorch versions
  (``kernels/ref.py``), mirroring ``repro.engine.IntegerBackend``: the
  bit-exact oracle;
* ``"cuda"`` (:class:`CudaBackend`) -- the hand-written Hopper kernels,
  mirroring ``repro.engine.PallasBackend``.  Every wrapper runs its plain
  version on CPU tensors and its kernel on CUDA tensors, so this backend
  serves on either device and is bit-identical to ``"integer"``;
* :class:`XpikeformerEngine` -- ``from_config(name, task="lm")``,
  ``init``, ``serve`` and ``generate`` over the dense scheduler.

A linear param leaf is a float weight ``[d_in, d_out]``, a ``{"w", "b"}``
dict, or a pre-quantised ``{"levels", "scale", "b"}`` dict (what
:func:`repro_torch.models.transformer.quantize_params` makes once per
scheduler, where the reference re-quantises inside every jitted step).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Protocol, Union

import torch

from repro_torch import aimc_device as AD
from repro_torch.device import resolve_device
from repro_torch.kernels import decode_fused as KFD
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels import ref as KREF
from repro_torch.kernels.plan import AttnSpec, KVView

Tensor = torch.Tensor


class Backend(Protocol):
    """A compute substrate for the spiking primitives of dense serving."""

    name: str

    def spiking_linear(self, p: Any, spikes: Tensor) -> Tensor:
        """``LIF(W s^t + b)`` over a ``[T, ..., d_in]`` spike train."""
        ...

    def decode_attention(self, view: KVView, q: Tensor, spec: AttnSpec, *,
                         slot_keys: Tensor) -> Tensor:
        """One-query SSA decode ``q [T,B,H,1,d]`` against a dense view
        ``k``/``v [T,B,H,L,d]``; per-slot keys ``[B, 2]``."""
        ...

    def decode_layer_fused(self, slot_keys, s, view, pos, wq, wk, wv,
                           wo=None, wi=None, wo2=None, *, hd, with_mlp=True):
        """One decoder layer step over the pre-scatter dense cache."""
        ...


def _linear_parts(p: Any) -> Dict[str, Any]:
    return p if isinstance(p, dict) else {"w": p, "b": None}


def _levels_scale(p: Dict[str, Any]):
    """Integer conductance levels (int8) + per-column scale of a linear
    leaf: pre-quantised leaves pass through, float weights quantise via
    :func:`repro_torch.aimc_device.quantize_weights`."""
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


def _flatten_time(spikes: Tensor):
    """``[T, *lead, d_in] -> ([T, M, d_in], unflatten)``."""
    t, lead, d_in = spikes.shape[0], spikes.shape[1:-1], spikes.shape[-1]

    def unflatten(out: Tensor) -> Tensor:
        return out.reshape((t,) + tuple(lead) + (out.shape[-1],))

    return spikes.reshape(t, -1, d_in), unflatten


def _dense_only(view: KVView) -> None:
    if view.paged:
        raise NotImplementedError("paged KV views are not ported yet")


class IntegerBackend:
    """The bit-exact oracle: plain PyTorch versions of every kernel, with
    the comparator draws of the reference's integer backend."""

    name = "integer"

    def decode_attention(self, view, q, spec, *, slot_keys):
        _dense_only(view)
        t, b, h, _, d = q.shape
        l = view.k.shape[3]
        rs, ra = KOPS.draw_slot_decode_prns(slot_keys, t, h, l, d,
                                            spec.i_max, spec.h0)
        g = b * t * h
        out = KREF.ssa_decode_ref(
            q.movedim(1, 0).reshape(g, 1, d), view.k.movedim(1, 0).reshape(g, l, d),
            view.v.movedim(1, 0).reshape(g, l, d), rs.reshape(g, 1, l),
            ra.reshape(g, 1, d))
        return out.reshape(b, t, h, 1, d).movedim(0, 1)

    def decode_layer_fused(self, slot_keys, s, view, pos, wq, wk, wv,
                           wo=None, wi=None, wo2=None, *, hd, with_mlp=True):
        _dense_only(view)
        ws = _triples(wq, wk, wv, wo, wi, wo2)
        h = ws[0][0].shape[1] // hd
        rs4, ra4 = KFD.draw_layer_prns(slot_keys, s.shape[0], h,
                                       view.k.shape[2], hd)
        return KREF.decode_layer_ref(
            s, view.k, view.v, pos, *ws, rs4, ra4, hd=hd, with_mlp=with_mlp)

    def spiking_linear(self, p, spikes):
        p = _linear_parts(p)
        levels, scale = _levels_scale(p)
        flat, unflatten = _flatten_time(spikes)
        out = KREF.aimc_spiking_linear_ref(flat.to(torch.float32), levels,
                                           scale, p.get("b"))
        return unflatten(out)


class CudaBackend:
    """The hand-written Hopper kernels: K1 (spiking linear), K2 (SSA decode
    row), K3 (fused decoder layer).  Bit-exact vs :class:`IntegerBackend`."""

    name = "cuda"

    def decode_attention(self, view, q, spec, *, slot_keys):
        _dense_only(view)
        return KOPS.ssa_attention_decode_packed(
            q, view.k, view.v, slot_keys, spec.h0, i_max=spec.i_max)

    def decode_layer_fused(self, slot_keys, s, view, pos, wq, wk, wv,
                           wo=None, wi=None, wo2=None, *, hd, with_mlp=True):
        _dense_only(view)
        return KFD.fused_decode_layer(
            slot_keys, s, view.k, view.v, pos,
            *_triples(wq, wk, wv, wo, wi, wo2), hd=hd, with_mlp=with_mlp)

    def spiking_linear(self, p, spikes):
        p = _linear_parts(p)
        levels, scale = _levels_scale(p)
        flat, unflatten = _flatten_time(spikes)
        out = KOPS.aimc_spiking_linear(flat.contiguous(), levels, scale,
                                       p.get("b"))
        return unflatten(out)


BACKENDS = {"integer": IntegerBackend, "cuda": CudaBackend}


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
    """One handle over a spiking GPT on the LM stack: config, backend,
    device and params, with continuous-batching :meth:`serve`."""

    cfg: Any
    backend: Backend
    device: torch.device
    params: Any = None
    _schedulers: Dict[Any, Any] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @classmethod
    def from_config(cls, name_or_cfg, *, task: str = "lm",
                    backend: Union[str, Backend] = "cuda",
                    reduced: bool = False,
                    device: Union[str, torch.device] = "cuda"
                    ) -> "XpikeformerEngine":
        """Build from a registered spiking GPT name (``reduced=True`` for
        the CPU smoke size) or a :class:`~repro_torch.configs.ModelConfig`.
        Only ``task="lm"`` is ported."""
        from repro_torch.configs import get_config, reduced_config

        if task != "lm":
            raise NotImplementedError(f"task {task!r} is not ported yet")
        if isinstance(name_or_cfg, str):
            cfg = reduced_config(name_or_cfg) if reduced else get_config(name_or_cfg)
        else:
            cfg = name_or_cfg
        return cls(cfg=cfg, backend=get_backend(backend),
                   device=resolve_device(device))

    def init(self, seed: int = 0):
        """Random weights from ``seed`` (``torch.Generator``)."""
        from repro_torch.models import transformer as T

        self.params = T.init_params(self.cfg, seed, self.device)
        return self.params

    def scheduler(self, *, slots: int = 4, cache_len: int = 64,
                  decode_kernel: str = "auto"):
        """A dense :class:`repro_torch.serving.BatchScheduler`, cached per
        geometry and reset on reuse."""
        from repro_torch.serving import BatchScheduler

        if self.params is None:
            raise ValueError("call init() first or set params")
        key = (slots, cache_len, decode_kernel)
        sch = self._schedulers.get(key)
        if sch is not None and sch.source_params is self.params:
            sch.reset()
            return sch
        sch = BatchScheduler(self.params, self.cfg, self.backend, slots=slots,
                             cache_len=cache_len, decode_kernel=decode_kernel,
                             device=self.device)
        self._schedulers[key] = sch
        return sch

    def serve(self, prompts, max_new: int = 16, *, slots: int = 4,
              cache_len: int = 64, seed: int = 0, decode_kernel: str = "auto"):
        """Continuous-batching serve: prompts -> (outputs, ServeStats);
        request ``i`` draws from the PRN stream ``seed + i``."""
        sch = self.scheduler(slots=slots, cache_len=cache_len,
                             decode_kernel=decode_kernel)
        rids = [sch.submit(p, max_new, seed=seed + i)
                for i, p in enumerate(prompts)]
        outs = sch.run()
        return [outs[r] for r in rids], sch.stats

    def generate(self, prompts, max_new: int = 16, **kwargs):
        """Greedy batch decode: prompts -> generated token-id lists."""
        outs, _ = self.serve(prompts, max_new, **kwargs)
        return outs
