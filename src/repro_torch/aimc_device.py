"""The programmed-PCM lifecycle: program, drift, recalibrate (GDC).

Twin of ``repro.aimc_device``.  :class:`AIMCDeviceState` holds one
programmed weight matrix ``[..., d_in, d_out]`` (leading axes free: a
stacked period leaf of the LM stack is one state) as tensors on one
device:

* **program** -- quantise the float weights to 5-bit differential-pair
  levels (Table II), draw the frozen programming error ``eps`` and the
  per-device drift exponents ``nu`` (the :func:`repro_torch.prng.normal`
  twin of ``jax.random.normal``), set the device clock to t = 0;
* **drift_to** -- move the clock and refresh the digital execution image
  ``levels_t``: the drifted conductances ``(levels + eps) * (t/t0)**-nu``
  re-digitised onto the int8 image grid by K6 (:func:`repro_torch.kernels.
  drift_requantize.drift_fold_kernel`: on the card one launch folds a
  whole tree, :func:`drift_tree`, up to 32 leaves a launch);
* **recalibrate** -- global drift compensation (paper §V-B): the ratio of
  the integer abs-sums of the image at t = 0 and at t (K6's calibration
  read, :func:`repro_torch.kernels.drift_requantize.drift_abs_sums_kernel`:
  two launches a tree, :func:`recalibrate_tree`), folded into the per-column scale until
  the next recalibration.

The digital backends execute ``levels_t`` and :attr:`AIMCDeviceState.
eff_scale` (an int8 crossbar product); :func:`analog_matmul` is the analog
simulation the paper models' float patch/embed and head linears run
through (per-device drift, read noise, the shared ADC, the stored GDC
gain).  Where the reference returns a new pytree these functions return a
new state (``dataclasses.replace``); no tensor is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.core import aimc as AM
from repro_torch.core.aimc import AIMCConfig
from repro_torch.kernels import drift_requantize as KD
from repro_torch.kernels import ref as KREF

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Table-II quantisation (single source of truth)
# ---------------------------------------------------------------------------


def quantize_weights(w: Tensor, cfg: AIMCConfig = AIMCConfig()
                     ) -> Tuple[Tensor, Tensor]:
    """Float weights ``[..., d_in, d_out]`` -> (integer levels as float,
    float32 column scale); every leading axis quantises independently."""
    w = w.to(torch.float32)
    scale = AM.column_scale(w, cfg)
    return AM.quantize_levels(w, scale, cfg), scale


def _drift_factor(nu: Tensor, t_seconds, cfg: AIMCConfig) -> Tensor:
    """``(max(t, t0) / t0) ** -nu`` as ``exp(-nu * log(.))``, the op
    sequence of K6 and of the reference; ``t_seconds`` is a scalar or one
    time per leading index of ``nu``."""
    return KREF.drift_factor_ref(nu, t_seconds, cfg.drift_t0_s)


def image_gain(cfg: AIMCConfig) -> int:
    """Integer gain of the digital execution image: the finest grid of
    int8 steps per programming level that cannot saturate (levels plus 4
    sigma of programming error)."""
    return max(int(127.0 // (cfg.levels * (1.0 + 4.0 * cfg.prog_noise_sigma))), 1)


# ---------------------------------------------------------------------------
# The device state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AIMCDeviceState:
    """Programmed PCM crossbar state of one weight matrix ``[..., d_in,
    d_out]`` (``repro.aimc_device.AIMCDeviceState``).

    Set once by :func:`program`: ``levels`` (ideal integer levels, f32),
    ``eps`` (programming error in level units), ``nu`` (drift exponents),
    ``scale`` (per-column ``[..., d_out]``).  Moved by :func:`drift_to` /
    :func:`recalibrate`, with fixed shapes: ``t_seconds [...]`` (the
    clock), ``gdc_gain [...]`` (stale between recalibrations),
    ``levels_t`` (int8 image at ``t_seconds``), ``img_inv [...]`` (``1 /
    image_gain``, frozen at program time)."""

    levels: Tensor
    eps: Tensor
    nu: Tensor
    scale: Tensor
    t_seconds: Tensor
    gdc_gain: Tensor
    levels_t: Tensor
    img_inv: Tensor

    @property
    def eff_scale(self) -> Tensor:
        """``scale * (gdc_gain * img_inv)``: the per-column f32 operand of
        the digital matmul over ``levels_t`` (the reference's op order)."""
        return (self.scale * (self.gdc_gain * self.img_inv)[..., None]
                ).to(torch.float32)

    @property
    def analog_scale(self) -> Tensor:
        """``scale * gdc_gain``: the analog path's per-column scale (level
        units of the programming grid, no image-grid factor)."""
        return (self.scale * self.gdc_gain[..., None]).to(torch.float32)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.levels.shape)

    def map(self, fn: Callable[[Tensor], Tensor]) -> "AIMCDeviceState":
        """The state with ``fn`` applied to every tensor (a device move, a
        leading-index slice)."""
        return AIMCDeviceState(*(fn(getattr(self, f.name))
                                 for f in dataclasses.fields(self)))


def _img_gain(state: AIMCDeviceState) -> Tensor:
    """The image grid frozen at program time, per leading index: ``round(1
    / img_inv)`` (the rounding repairs the f32 reciprocal, e.g. of 1/7),
    never re-derived from a caller's config; K6 computes the same on the
    card."""
    return KREF.img_gain_ref(state.img_inv)


def _leaf(state: AIMCDeviceState, t_seconds: Optional[Tensor]
          ) -> KD.FoldLeaf:
    """K6's operands of one state at ``t_seconds`` (``None``: t = 0)."""
    return KD.FoldLeaf(state.levels, state.eps, state.nu, t_seconds,
                       state.img_inv)


def program(key: Tensor, w: Tensor, cfg: AIMCConfig) -> AIMCDeviceState:
    """Program float weights ``[..., d_in, d_out]`` onto simulated PCM:
    quantise (Table II), draw the frozen programming error and drift
    exponents from ``key`` (split in two, as the reference splits it), set
    the clock to t = 0 with a unit GDC gain.  The state lives on ``w``'s
    device."""
    k = prng.split(key.to(w.device))
    levels, scale = quantize_weights(w, cfg)
    shape = tuple(w.shape)
    eps = cfg.prog_noise_sigma * cfg.levels * prng.normal(k[0], shape)
    nu = cfg.drift_nu_mean + cfg.drift_nu_sigma * prng.normal(k[1], shape)
    nu = torch.clamp_min(nu, 0.0)
    lead = shape[:-2]
    t0 = torch.zeros(lead, dtype=torch.float32, device=w.device)
    img_inv = torch.full(lead, 1.0 / image_gain(cfg), dtype=torch.float32,
                         device=w.device)
    (levels_t,) = KD.drift_fold_kernel(
        [KD.FoldLeaf(levels, eps, nu, t0, img_inv)], t0=cfg.drift_t0_s)
    return AIMCDeviceState(
        levels=levels, eps=eps, nu=nu, scale=scale, t_seconds=t0,
        gdc_gain=torch.ones(lead, dtype=torch.float32, device=w.device),
        levels_t=levels_t, img_inv=img_inv)


def drift_to(state: AIMCDeviceState, t_seconds, cfg: AIMCConfig
             ) -> AIMCDeviceState:
    """Move the clock to ``t_seconds`` (absolute, since programming) and
    refresh ``levels_t`` (K6 with one leaf); the GDC gain moves only at
    :func:`recalibrate`."""
    return _drift_states([state], t_seconds, cfg)[0]


def recalibrate(state: AIMCDeviceState, cfg: AIMCConfig,
                reduce: Optional[Callable[[Tensor], Tensor]] = None
                ) -> AIMCDeviceState:
    """GDC at the state's own clock: ``gain = sum|img(0)| / max(sum|img(t)|,
    1)``, both images re-folded from the programming record (K6's
    calibration read: two launches, no image written) and summed as
    integers over each matrix, as the calibration read through the shared
    ADC accumulates them.

    ``reduce`` completes the two sums of a matrix split over a mesh's
    ranks (``ServingMesh.all_reduce_model``): the partial sums travel as
    float64, exact for any integer below 2**53, so every rank measures
    the whole matrix's gain, bit for bit."""
    return _recalibrate_states([state], cfg, reduce)[0]


def _views(flat: Tensor, states: List[AIMCDeviceState]) -> List[Tensor]:
    """``flat`` (one value a matrix of every state in order) cut into one
    view of each state's leading shape."""
    out, off = [], 0
    for s in states:
        lead = s.t_seconds.shape
        k = s.t_seconds.numel()
        out.append(flat[off:off + k].view(lead))
        off += k
    return out


def _with(state: AIMCDeviceState, **changes) -> AIMCDeviceState:
    """``dataclasses.replace`` without its introspection (a fold rebuilds
    every state of a tree)."""
    fields = {f: getattr(state, f) for f in _FIELDS}
    fields.update(changes)
    return AIMCDeviceState(**fields)


_FIELDS = tuple(f.name for f in dataclasses.fields(AIMCDeviceState))


def _drift_states(states: List[AIMCDeviceState], t_seconds, cfg: AIMCConfig
                  ) -> List[AIMCDeviceState]:
    """The states (all on one device) moved to ``t_seconds`` (a scalar, or
    a tensor that broadcasts to each state's clock) by one grouped K6 fold.
    A scalar clock is one filled tensor a leading shape, shared by the
    states of that shape (no state's tensors are written in place)."""
    dev = states[0].levels.device
    if not isinstance(t_seconds, (int, float)):
        t = torch.as_tensor(t_seconds, dtype=torch.float32, device=dev)
        ts = [torch.broadcast_to(t, s.t_seconds.shape).contiguous()
              for s in states]
    else:
        by_lead, ts = {}, []
        for s in states:
            lead = s.t_seconds.shape
            if lead not in by_lead:
                by_lead[lead] = torch.full(lead, float(t_seconds),
                                           dtype=torch.float32, device=dev)
            ts.append(by_lead[lead])
    imgs = KD.drift_fold_kernel([_leaf(s, t) for s, t in zip(states, ts)],
                           t0=cfg.drift_t0_s)
    return [_with(s, t_seconds=t, levels_t=img)
            for s, t, img in zip(states, ts, imgs)]


def _recalibrate_states(states: List[AIMCDeviceState], cfg: AIMCConfig,
                        reduce: Optional[Callable[[Tensor], Tensor]]
                        ) -> List[AIMCDeviceState]:
    """GDC of the states (all on one device): two grouped calibration reads
    (t = 0, each state's t), ``reduce`` once on each, the gains of every
    matrix in one division, one view a state."""
    t0 = cfg.drift_t0_s
    g0 = KD.drift_abs_sums_kernel([_leaf(s, None) for s in states], t0=t0)
    gt = KD.drift_abs_sums_kernel([_leaf(s, s.t_seconds) for s in states], t0=t0)
    if reduce is not None:
        g0 = reduce(g0.to(torch.float64)).to(torch.int32)
        gt = reduce(gt.to(torch.float64)).to(torch.int32)
    gdc = g0.to(torch.float32) / torch.clamp_min(gt, 1).to(torch.float32)
    return [_with(s, gdc_gain=g) for s, g in zip(states, _views(gdc, states))]


# ---------------------------------------------------------------------------
# Analog execution (the paper models' float linears)
# ---------------------------------------------------------------------------


def analog_matmul(key: Optional[Tensor], x: Tensor, state: AIMCDeviceState,
                  cfg: AIMCConfig) -> Tensor:
    """``x [..., d_in] @ W`` through the analog crossbar simulation of one
    2-D state: per-device drift at the state's clock, 128-row blocks whose
    f32 partial sums take read noise (normals of the threefry twin, drawn
    from ``key``) and the shared ADC, an exact digital sum of the blocks,
    the stored (stale) GDC gain."""
    if state.levels.ndim != 2:
        raise ValueError("analog_matmul executes one crossbar array "
                         f"(a 2-D state), not {state.shape}")
    d_in, d_out = state.shape
    g = (state.levels + state.eps) * _drift_factor(state.nu, state.t_seconds,
                                                   cfg)
    rows = cfg.crossbar_rows
    pad = (-d_in) % rows
    x = x.to(torch.float32)
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        g = torch.nn.functional.pad(g, (0, 0, 0, pad))
    nb = g.shape[0] // rows
    xb = x.reshape(*x.shape[:-1], nb, rows)
    partial = torch.einsum("...br,brd->...bd", xb, g.reshape(nb, rows, d_out))
    if key is not None and cfg.read_noise_sigma > 0:
        partial = partial + cfg.read_noise_sigma * cfg.levels * prng.normal(
            key.to(x.device), tuple(partial.shape))
    out = torch.sum(AM._adc(partial, cfg), dim=-2)
    return out * state.analog_scale


# ---------------------------------------------------------------------------
# Trees of parameters
# ---------------------------------------------------------------------------


def _is_state(x: Any) -> bool:
    return isinstance(x, AIMCDeviceState)


def _is_legacy(x: Any) -> bool:
    return isinstance(x, dict) and "hw" in x and not _is_state(x["hw"])


def _leaves(tree: Any, is_leaf: Callable[[Any], bool]) -> List[Any]:
    """The leaves of a tree of dicts and lists in ``jax.tree.flatten``'s
    order: dict keys sorted, lists in order, ``None`` no leaf."""
    if tree is None:
        return []
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v, is_leaf)]
    return [tree]


def map_tree(fn: Callable[[Any], Any], tree: Any,
             is_leaf: Callable[[Any], bool] = _is_state) -> Any:
    """``fn`` over the leaves where ``is_leaf`` holds; the rest of the tree
    (dicts, lists, other leaves) is kept."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, is_leaf) for v in tree]
    return tree


def is_programmed(tree: Any) -> bool:
    """True if any leaf is an :class:`AIMCDeviceState` or a legacy
    ``{"hw": {...}}`` programmed dict."""
    return any(_is_state(x) or _is_legacy(x) for x in
               _leaves(tree, lambda x: _is_state(x) or _is_legacy(x)))


def has_device_state(tree: Any) -> bool:
    """True if any leaf is an :class:`AIMCDeviceState` (a legacy dict has
    no clock: the lifecycle cannot act on it)."""
    return any(_is_state(x) for x in _leaves(tree, _is_state))


def program_tree(key: Tensor, params: Any, cfg: AIMCConfig) -> Any:
    """Replace every ``{"w", "b"}`` linear of a paper model by ``{"hw":
    state, "b": b}``.  One key is split over the tree's leaves in
    ``jax.tree.flatten`` order (every leaf takes a key, linear or not), so
    each linear gets the reference's key.  Raises on a programmed tree:
    programming is one-shot."""
    if is_programmed(params):
        raise ValueError(
            "params are already programmed onto PCM (AIMCDeviceState leaves "
            "present); program once, then use drift_to()/recalibrate() for "
            "the device lifecycle")

    def is_lin(x):
        return isinstance(x, dict) and "w" in x and "b" in x

    lins = _leaves(params, is_lin)
    keys = prng.split(key, max(len(lins), 1))
    by_id = {id(leaf): keys[i] for i, leaf in enumerate(lins) if is_lin(leaf)}
    return map_tree(
        lambda p: {"hw": program(by_id[id(p)], p["w"].to(torch.float32), cfg),
                   "b": p["b"]}, params, is_lin)


def _matrix_view(name: str, w: Tensor) -> Tensor:
    """The ``[..., d_in, d_out]`` crossbar view of an LM-stack weight that
    is stored per head."""
    if name in ("wq", "wk", "wv"):  # [..., d, h, hd] -> [..., d, h*hd]
        return w.reshape(*w.shape[:-2], w.shape[-2] * w.shape[-1])
    if name == "wo" and w.ndim >= 3:  # [..., h, hd, d] -> [..., h*hd, d]
        return w.reshape(*w.shape[:-3], w.shape[-3] * w.shape[-2], w.shape[-1])
    return w


def program_lm_tree(key: Tensor, params: Any, cfg: AIMCConfig) -> Any:
    """Program the LM stack's spiking linears (attention ``wq/wk/wv/wo``,
    MLP ``wi/wo``) onto PCM; stacked ``periods`` leaves keep their leading
    axis.  Key ``i`` is ``fold_in(key, i)``, counted over ``periods`` then
    ``remainder``, each block's attention then MLP weights, as the
    reference counts.  Norms, embed and unembed stay digital."""
    if is_programmed(params):
        raise ValueError(
            "params are already programmed onto PCM; program once, then use "
            "drift_to()/recalibrate()")
    params = dict(params)
    n = [0]

    def prog(w):
        k = prng.fold_in(key, n[0])
        n[0] += 1
        return program(k, w.to(torch.float32), cfg)

    def prog_block(blk):
        blk = dict(blk)
        mix = blk.get("mixer")
        if isinstance(mix, dict) and {"wq", "wk", "wv", "wo"} <= set(mix):
            mix = dict(mix)
            for name in ("wq", "wk", "wv", "wo"):
                mix[name] = prog(_matrix_view(name, mix[name]))
            blk["mixer"] = mix
        mlp = blk.get("mlp")
        if isinstance(mlp, dict) and {"wi", "wo"} <= set(mlp):
            mlp = dict(mlp)
            for name in ("wi", "wo"):
                mlp[name] = prog(mlp[name])
            blk["mlp"] = mlp
        return blk

    for group in ("periods", "remainder"):
        if group in params:
            params[group] = {bk: prog_block(bv)
                             for bk, bv in params[group].items()}
    return params


def _collect_states(tree: Any, out: List[AIMCDeviceState]) -> None:
    """The tree's states in :func:`map_tree`'s order (the tree's own, the
    same on every rank of a mesh)."""
    if _is_state(tree):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _collect_states(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _collect_states(v, out)


def _map_states_grouped(fn, params: Any) -> Any:
    """``fn(states) -> new states`` over the tree's distinct states, once
    for each device's states; the tree with each state replaced."""
    found: List[AIMCDeviceState] = []
    _collect_states(params, found)
    by_dev = {}
    for s in found:
        by_dev.setdefault(s.levels.device, {}).setdefault(id(s), s)
    new = {}
    for group in by_dev.values():
        states = list(group.values())
        new.update(zip(group, fn(states)))
    return map_tree(lambda s: new[id(s)], params)


def drift_tree(params: Any, t_seconds, cfg: AIMCConfig) -> Any:
    """Every device state of a tree moved to ``t_seconds``: on each device
    one fill of the clocks and one grouped K6 fold of every leaf."""
    return _map_states_grouped(
        lambda states: _drift_states(states, t_seconds, cfg), params)


def recalibrate_tree(params: Any, cfg: AIMCConfig,
                     reduce: Optional[Callable[[Tensor], Tensor]] = None
                     ) -> Any:
    """Every device state of a tree GDC-recalibrated at its own clock: on
    each device two grouped calibration reads and one ``reduce`` of each
    (``reduce``: see :func:`recalibrate`; a mesh rank's tree holds only
    split states, in the same order on every rank)."""
    return _map_states_grouped(
        lambda states: _recalibrate_states(states, cfg, reduce), params)


def device_states(params: Any) -> List[AIMCDeviceState]:
    """The device states of a tree, in ``jax.tree.flatten`` order."""
    return [x for x in _leaves(params, _is_state) if _is_state(x)]


def device_time(params: Any) -> float:
    """The latest device clock across a tree (0.0 if nothing is
    programmed); one host read per state."""
    ts = [float(torch.max(s.t_seconds)) for s in device_states(params)]
    return max(ts) if ts else 0.0


def gdc_gain_summary(params: Any) -> float:
    """The mean over the tree's states of each state's mean GDC gain (1.0
    if nothing is programmed)."""
    gains = [float(torch.mean(s.gdc_gain)) for s in device_states(params)]
    return sum(gains) / len(gains) if gains else 1.0


# ---------------------------------------------------------------------------
# Serving drift policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DriftPolicy:
    """How a long-running server advances PCM device time
    (``repro.aimc_device.DriftPolicy``).

    seconds_per_step -- device seconds per batched decode step; 0.0 means
                        the step's wall time times ``time_scale``
    time_scale       -- device seconds per wall-clock second
    recal_interval_s -- GDC whenever this much device time has passed
                        since the last one; 0.0 never recalibrates
    cfg              -- the AIMC configuration (Table II) of the updates
    """

    seconds_per_step: float = 0.0
    time_scale: float = 1.0
    recal_interval_s: float = 0.0
    cfg: AIMCConfig = dataclasses.field(default_factory=AIMCConfig)

