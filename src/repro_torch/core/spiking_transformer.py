"""The paper's models: spiking ViT (Table III) and spiking GPT (Table IV).

Twin of ``repro.core.spiking_transformer`` in its three attention modes,
the paper's comparison rows: ``"ssa"`` (stochastic spiking attention, the
Xpikeformer rows, every entry of :data:`repro_torch.configs.xpikeformer.
SPIKING_ARCHS`), ``"lif"`` (the Spikformer baseline: the same spiking
blocks with :func:`repro_torch.core.ssa.lif_spiking_attention` in place of
SSA) and ``"ann"`` (the float transformer: LayerNorm, softmax attention,
GELU; ``_ln``, ``_ann_block``), and its three weight modes (an
:class:`AIMCSim`): ideal float weights (``"ideal"``, conventional
training), hardware-aware training's noisy forward (``"hwat"``:
:func:`repro_torch.core.aimc.hwat_weights` for every float linear, one
draw a linear a forward from its key) and programmed PCM state (``"hw"``,
after :func:`program_model`).

The spiking primitives come from a backend (:mod:`repro_torch.engine`):
``spiking_linear`` (K1 on the card) for the six crossbar linears of a
block, given the linear's key and the sim, and ``ssa_attention`` (K8) for
the attention tile.  The float reference backend (``"reference"``) is the
differentiable one that training runs; the digital backends execute a
weight's int8 image and ignore the key and the sim.  The ``"ann"`` mode
runs no spiking primitive, so no backend changes its result.  The
patch/embed and head linears consume or produce real values, so they stay
outside the kernels: float ``x @ w + b`` (``torch.matmul`` in f32) with
ideal or HWAT weights, the analog crossbar simulation
(:func:`repro_torch.aimc_device.analog_matmul`, with read noise drawn from
the linear's key) when programmed, as the reference does.  Spike
randomness comes from the threefry twin (:mod:`repro_torch.prng`): with
the same key a forward draws the reference's rate-coding uniforms,
comparator integers and HWAT noise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Union

import torch

from repro_torch import aimc_device as AD
from repro_torch import prng
from repro_torch.core import aimc as AM
from repro_torch.core import spikes as SP
from repro_torch.core import ssa as SSA
from repro_torch.core.aimc import AIMCConfig
from repro_torch.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AIMCSim:
    """``repro.core.spiking_transformer.AIMCSim`` without the legacy
    state's clock and GDC flag (a programmed leaf carries its own): the
    weight mode and the Table-II configuration."""

    wmode: str = "ideal"  # ideal | hwat | hw
    cfg: AIMCConfig = AIMCConfig()


IDEAL_SIM = AIMCSim()


@dataclasses.dataclass(frozen=True)
class SpikingConfig:
    """A copy of ``repro.core.spiking_transformer.SpikingConfig``."""

    depth: int
    dim: int
    num_heads: int
    T: int = 4
    mode: str = "ssa"  # ann | lif | ssa
    mlp_ratio: int = 4
    # ViT task
    image_size: int = 32
    patch_size: int = 4
    num_classes: int = 10
    in_channels: int = 3
    # GPT task
    input_dim: int = 0  # continuous token features (ICL symbol detection)
    vocab: int = 0  # output classes

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def check_wmode(wmode: str) -> None:
    """Raise for an unknown weight mode."""
    if wmode not in ("ideal", "hwat", "hw"):
        raise ValueError(f"unknown wmode {wmode!r}; known: ideal, hw, hwat")


def check_ported(cfg: SpikingConfig, wmode: str = "ideal") -> None:
    """Raise for an unknown attention or weight mode."""
    if cfg.mode not in ("ann", "lif", "ssa"):
        raise ValueError(f"unknown mode {cfg.mode!r}; known: ann, lif, ssa")
    check_wmode(wmode)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _linear_def(gen: torch.Generator, d_in: int, d_out: int
                ) -> Dict[str, Tensor]:
    w = torch.randn((d_in, d_out), generator=gen) / math.sqrt(d_in)
    return {"w": w, "b": torch.zeros(d_out)}


def _block_def(gen: torch.Generator, cfg: SpikingConfig) -> Dict[str, Any]:
    d, f = cfg.dim, cfg.mlp_ratio * cfg.dim
    return {
        "ln1": {"scale": torch.ones(d), "bias": torch.zeros(d)},
        "ln2": {"scale": torch.ones(d), "bias": torch.zeros(d)},
        "wq": _linear_def(gen, d, d), "wk": _linear_def(gen, d, d),
        "wv": _linear_def(gen, d, d), "wo": _linear_def(gen, d, d),
        "w1": _linear_def(gen, d, f), "w2": _linear_def(gen, f, d),
    }


def _to(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def init_vit(cfg: SpikingConfig, seed: int,
             device: Union[str, torch.device, None] = None) -> Dict[str, Any]:
    """Random ViT weights from ``seed`` (a CPU ``torch.Generator``, so the
    values do not depend on the device), placed on ``device`` (the card
    unless the caller asks for the CPU); the reference's tree and shapes
    (the unused ``ln1``/``ln2`` included)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    pdim = cfg.patch_size * cfg.patch_size * cfg.in_channels
    params = {
        "patch": _linear_def(gen, pdim, cfg.dim),
        "pos": torch.randn((cfg.num_patches, cfg.dim), generator=gen) * 0.02,
        "blocks": [_block_def(gen, cfg) for _ in range(cfg.depth)],
        "head": _linear_def(gen, cfg.dim, cfg.num_classes),
    }
    return _to(params, device)


def init_gpt(cfg: SpikingConfig, seed: int,
             device: Union[str, torch.device, None] = None) -> Dict[str, Any]:
    """Random GPT weights from ``seed`` on ``device`` (as :func:`init_vit`);
    a 512-row position table, as in the reference."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {
        "embed": _linear_def(gen, cfg.input_dim, cfg.dim),
        "pos": torch.randn((512, cfg.dim), generator=gen) * 0.02,
        "blocks": [_block_def(gen, cfg) for _ in range(cfg.depth)],
        "head": _linear_def(gen, cfg.dim, cfg.vocab),
    }
    return _to(params, device)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def linear(p: Dict[str, Any], x: Tensor, sim: AIMCSim = IDEAL_SIM,
           key: Tensor = None) -> Tensor:
    """A float-valued linear: ``x @ w + b`` in f32 for float weights
    (``sim.wmode == "hwat"``: :func:`repro_torch.core.aimc.hwat_weights`
    drawn from ``key``); for a programmed ``{"hw", "b"}`` leaf the analog
    crossbar simulation at the state's clock with read noise from ``key``,
    plus ``b``."""
    if "hw" in p:
        hw = p["hw"]
        if not isinstance(hw, AD.AIMCDeviceState):
            raise NotImplementedError(
                "legacy {'hw': dict} leaves (core/aimc.py:program_weights) "
                "are not ported: ROADMAP A12")
        return AD.analog_matmul(key, x, hw, sim.cfg) + p["b"]
    w = p["w"]
    if sim.wmode == "hwat":
        w = AM.hwat_weights(key, w, sim.cfg)
    return torch.matmul(x, w) + p["b"]


def program_model(key: Tensor, params: Any, cfg: AIMCConfig) -> Any:
    """Replace every ``{"w", "b"}`` linear by ``{"hw": AIMCDeviceState,
    "b": b}`` with the clock at t = 0
    (:func:`repro_torch.aimc_device.program_tree`); raises on a tree that
    is already programmed."""
    return AD.program_tree(key, params, cfg)


def patchify(images: Tensor, patch: int) -> Tensor:
    """``[B, H, W, C]`` -> ``[B, (H/p)(W/p), p*p*C]``, row-major patches."""
    b, hh, ww, c = images.shape
    ph, pw = hh // patch, ww // patch
    x = images.reshape(b, ph, patch, pw, patch, c)
    return x.movedim(3, 2).reshape(b, ph * pw, patch * patch * c)


def _ln(p: Dict[str, Tensor], x: Tensor) -> Tensor:
    """LayerNorm in f32 with ``eps = 1e-6`` (the ANN rows)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.var(xf, -1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + 1e-6)) * p["scale"] + p["bias"]


def _ann_block(p: Dict[str, Any], x: Tensor, cfg: SpikingConfig,
               keys: Tensor, sim: AIMCSim, *, causal: bool) -> Tensor:
    """``x [B,N,D]`` -> the same after one float block (the ANN rows):
    LayerNorm, softmax attention and a GELU MLP (tanh approximation, as
    ``jax.nn.gelu``), each with its residual.  The linears draw their
    noise (HWAT's or the programmed crossbars' read noise) from
    ``keys[0..5]``."""
    def lin(name, z, i):
        return linear(p[name], z, sim, keys[i])

    h = _ln(p["ln1"], x)
    q = SP.heads(lin("wq", h, 0), cfg.num_heads)
    k = SP.heads(lin("wk", h, 1), cfg.num_heads)
    v = SP.heads(lin("wv", h, 2), cfg.num_heads)
    a = SSA.ann_attention(q, k, v, causal=causal)
    x = x + lin("wo", SP.unheads(a), 3)
    h = _ln(p["ln2"], x)
    h = torch.nn.functional.gelu(lin("w1", h, 4), approximate="tanh")
    return x + lin("w2", h, 5)


def _spiking_block(p: Dict[str, Any], s: Tensor, cfg: SpikingConfig,
                   keys: Tensor, rng: Tensor, *, causal: bool, backend,
                   sim: AIMCSim = IDEAL_SIM) -> Tensor:
    """``s [T,B,N,D]`` integer-valued f32 -> the same after one block:
    Q/K/V spiking linears, SSA (``"lif"``: the LIF attention),
    attention-out and the FFN, each with its residual (Table I's SNN rows;
    no inter-layer normalisation).  The six linears take ``keys[0..5]``,
    the attention ``rng``."""
    def lin(name, z, i):
        return backend.spiking_linear(p[name], z, key=keys[i], sim=sim)

    q = SP.heads(lin("wq", s, 0), cfg.num_heads)  # [T,B,H,N,hd]
    k = SP.heads(lin("wk", s, 1), cfg.num_heads)
    v = SP.heads(lin("wv", s, 2), cfg.num_heads)
    if cfg.mode == "ssa":
        a = backend.ssa_attention(rng, q, k, v, causal=causal)
    else:  # "lif": the Spikformer baseline
        a = SSA.lif_spiking_attention(q.to(s.dtype), k.to(s.dtype),
                                      v.to(s.dtype), causal=causal)
    s = s + lin("wo", SP.unheads(a), 3)
    h = lin("w1", s, 4)
    return s + lin("w2", h, 5)


def _run_blocks(params: Dict[str, Any], x_or_s: Tensor, cfg: SpikingConfig,
                rng: Tensor, *, causal: bool, backend,
                sim: AIMCSim = IDEAL_SIM) -> Tensor:
    """Every block in turn; block ``i`` takes its keys from
    ``split(fold_in(rng, i), 7)``: 0-5 the linears' (HWAT's noise, or the
    reference backend's read noise on programmed linears; the digital
    backends draw nothing), 6 the attention's.  ``"ann"`` runs float
    blocks over ``x [B,N,D]``, the spiking modes spiking blocks over ``s
    [T,B,N,D]``."""
    for i, bp in enumerate(params["blocks"]):
        kk = prng.split(prng.fold_in(rng, i), 7)
        if cfg.mode == "ann":
            x_or_s = _ann_block(bp, x_or_s, cfg, kk, sim, causal=causal)
        else:
            x_or_s = _spiking_block(bp, x_or_s, cfg, kk, kk[6], causal=causal,
                                    backend=backend, sim=sim)
    return x_or_s


# ---------------------------------------------------------------------------
# Spiking ViT (Table III) and spiking GPT (Table IV)
# ---------------------------------------------------------------------------


def vit_forward(params: Dict[str, Any], images: Tensor, cfg: SpikingConfig,
                rng: Tensor, *, backend, sim: AIMCSim = IDEAL_SIM) -> Tensor:
    """``images [B,H,W,C]`` -> logits ``[B, classes]``: patch embed, rate
    coding, the spiking blocks (non-causal SSA), firing rates pooled over
    the patches, float head; ``"ann"``: the float blocks over the
    embedding, pooled.  ``sim`` is the weight mode and the Table-II
    configuration."""
    check_ported(cfg, sim.wmode)
    keys = prng.split(rng, 4)  # embed, encode, blocks, head
    x = linear(params["patch"], patchify(images, cfg.patch_size), sim,
               keys[0]) + params["pos"]
    if cfg.mode == "ann":
        h = _run_blocks(params, x, cfg, keys[2], causal=False,
                        backend=backend, sim=sim)
        pooled = torch.mean(h, dim=1)
    else:
        s = SP.rate_encode(keys[1], torch.sigmoid(x), cfg.T)
        s = _run_blocks(params, s, cfg, keys[2], causal=False,
                        backend=backend, sim=sim)
        pooled = torch.mean(SP.rate_decode(s.to(torch.float32)), dim=1)
    return linear(params["head"], pooled, sim, keys[3])


def gpt_forward(params: Dict[str, Any], feats: Tensor, cfg: SpikingConfig,
                rng: Tensor, *, backend, sim: AIMCSim = IDEAL_SIM) -> Tensor:
    """``feats [B,L,input_dim]`` -> logits ``[B,L,vocab]``: embed plus
    position, rate coding, the spiking blocks (causal SSA), firing rates,
    float head; ``"ann"``: the float blocks over the embedding."""
    check_ported(cfg, sim.wmode)
    keys = prng.split(rng, 4)
    n = feats.shape[1]
    x = linear(params["embed"], feats, sim, keys[0]) + params["pos"][:n]
    if cfg.mode == "ann":
        h = _run_blocks(params, x, cfg, keys[2], causal=True,
                        backend=backend, sim=sim)
    else:
        s = SP.rate_encode(keys[1], torch.sigmoid(x), cfg.T)
        s = _run_blocks(params, s, cfg, keys[2], causal=True,
                        backend=backend, sim=sim)
        h = SP.rate_decode(s.to(torch.float32))
    return linear(params["head"], h, sim, keys[3])
