"""The paper's models: spiking ViT (Table III) and spiking GPT (Table IV).

Twin of ``repro.core.spiking_transformer`` for the Xpikeformer rows of the
paper: attention mode ``"ssa"`` (stochastic spiking attention), which is
every entry of :data:`repro_torch.configs.xpikeformer.SPIKING_ARCHS`, with
ideal float weights (``wmode="ideal"``) or programmed PCM state
(``wmode="hw"``, after :func:`program_model`).  The baseline modes
(``"ann"``, ``"lif"``) and hardware-aware training's noisy forward
(``"hwat"``) raise :class:`NotImplementedError`.

The spiking primitives come from a backend (:mod:`repro_torch.engine`):
``spiking_linear`` (K1) for the six crossbar linears of a block, which
executes a programmed leaf's drifted int8 image, and ``ssa_attention``
(K8) for the attention tile.  The patch/embed and head linears consume or
produce real values, so they stay outside the kernels: float ``x @ w + b``
(``torch.matmul`` in f32) with ideal weights, the analog crossbar
simulation (:func:`repro_torch.aimc_device.analog_matmul`, with read
noise drawn from the linear's key) when programmed, as the reference does.
Spike randomness comes from the threefry twin (:mod:`repro_torch.prng`):
with the same key a forward draws the reference's rate-coding uniforms
and comparator integers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Union

import torch

from repro_torch import aimc_device as AD
from repro_torch import prng
from repro_torch.core import spikes as SP
from repro_torch.core.aimc import AIMCConfig

Tensor = torch.Tensor


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
    """Raise for a weight mode this port does not run: ``"hwat"`` is
    training's."""
    if wmode == "hwat":
        raise NotImplementedError(
            "wmode='hwat' (hardware-aware training's noisy forward) is not "
            "ported yet: ROADMAP A11, training")
    if wmode not in ("ideal", "hw"):
        raise ValueError(f"unknown wmode {wmode!r}; known: ideal, hw, hwat")


def check_ported(cfg: SpikingConfig, wmode: str = "ideal") -> None:
    """Raise for the modes this port does not run yet."""
    if cfg.mode != "ssa":
        raise NotImplementedError(
            f"mode={cfg.mode!r} (the paper's ANN / Spikformer baseline rows) "
            "is not ported yet: ROADMAP A7, baseline modes")
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
             device: Union[str, torch.device] = "cpu") -> Dict[str, Any]:
    """Random ViT weights from ``seed`` (a CPU ``torch.Generator``, so the
    values do not depend on the device); the reference's tree and shapes
    (the unused ``ln1``/``ln2`` included)."""
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
             device: Union[str, torch.device] = "cpu") -> Dict[str, Any]:
    """Random GPT weights from ``seed``; a 512-row position table, as in
    the reference."""
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


def linear(p: Dict[str, Any], x: Tensor, cfg: AIMCConfig = AIMCConfig(),
           key: Tensor = None) -> Tensor:
    """A float-valued linear: ``x @ w + b`` in f32 for ideal weights; for a
    programmed ``{"hw", "b"}`` leaf the analog crossbar simulation at the
    state's clock with read noise from ``key``, plus ``b``."""
    if "hw" in p:
        hw = p["hw"]
        if not isinstance(hw, AD.AIMCDeviceState):
            raise NotImplementedError(
                "legacy {'hw': dict} leaves (core/aimc.py:program_weights) "
                "are not ported: ROADMAP A12")
        return AD.analog_matmul(key, x, hw, cfg) + p["b"]
    return torch.matmul(x, p["w"]) + p["b"]


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


def _heads(x: Tensor, h: int) -> Tensor:
    """``[..., N, d]`` -> ``[..., H, N, d/H]``."""
    *lead, n, d = x.shape
    return x.reshape(*lead, n, h, d // h).movedim(-2, -3)


def _unheads(x: Tensor) -> Tensor:
    """``[..., H, N, hd]`` -> ``[..., N, H*hd]``."""
    *lead, h, n, hd = x.shape
    return x.movedim(-3, -2).reshape(*lead, n, h * hd)


def _spiking_block(p: Dict[str, Any], s: Tensor, cfg: SpikingConfig,
                   rng: Tensor, *, causal: bool, backend) -> Tensor:
    """``s [T,B,N,D]`` integer-valued f32 -> the same after one block:
    Q/K/V spiking linears, SSA, attention-out and the FFN, each with its
    residual (Table I's SNN rows; no inter-layer normalisation)."""
    lin = backend.spiking_linear
    q = _heads(lin(p["wq"], s), cfg.num_heads)  # [T,B,H,N,hd] uint8
    k = _heads(lin(p["wk"], s), cfg.num_heads)
    v = _heads(lin(p["wv"], s), cfg.num_heads)
    a = _unheads(backend.ssa_attention(rng, q, k, v, causal=causal))
    s = s + lin(p["wo"], a)
    h = lin(p["w1"], s)
    return s + lin(p["w2"], h)


def _run_blocks(params: Dict[str, Any], s: Tensor, cfg: SpikingConfig,
                rng: Tensor, *, causal: bool, backend) -> Tensor:
    """Every block in turn; block ``i`` takes its attention key from
    ``split(fold_in(rng, i), 7)[6]`` (keys 0-5 belong to the linears,
    which draw nothing on the digital backends, programmed or not)."""
    for i, bp in enumerate(params["blocks"]):
        kk = prng.split(prng.fold_in(rng, i), 7)
        s = _spiking_block(bp, s, cfg, kk[6], causal=causal, backend=backend)
    return s


# ---------------------------------------------------------------------------
# Spiking ViT (Table III) and spiking GPT (Table IV)
# ---------------------------------------------------------------------------


def vit_forward(params: Dict[str, Any], images: Tensor, cfg: SpikingConfig,
                rng: Tensor, *, backend,
                aimc_cfg: AIMCConfig = AIMCConfig()) -> Tensor:
    """``images [B,H,W,C]`` -> logits ``[B, classes]``: patch embed, rate
    coding, the spiking blocks (non-causal SSA), firing rates pooled over
    the patches, float head.  ``aimc_cfg`` is the programmed linears'
    Table-II configuration."""
    check_ported(cfg)
    keys = prng.split(rng, 4)  # embed, encode, blocks, head
    x = linear(params["patch"], patchify(images, cfg.patch_size), aimc_cfg,
               keys[0]) + params["pos"]
    s = SP.rate_encode(keys[1], torch.sigmoid(x), cfg.T)
    s = _run_blocks(params, s, cfg, keys[2], causal=False, backend=backend)
    pooled = torch.mean(SP.rate_decode(s.to(torch.float32)), dim=1)
    return linear(params["head"], pooled, aimc_cfg, keys[3])


def gpt_forward(params: Dict[str, Any], feats: Tensor, cfg: SpikingConfig,
                rng: Tensor, *, backend,
                aimc_cfg: AIMCConfig = AIMCConfig()) -> Tensor:
    """``feats [B,L,input_dim]`` -> logits ``[B,L,vocab]``: embed plus
    position, rate coding, the spiking blocks (causal SSA), firing rates,
    float head."""
    check_ported(cfg)
    keys = prng.split(rng, 4)
    n = feats.shape[1]
    x = linear(params["embed"], feats, aimc_cfg, keys[0]) + params["pos"][:n]
    s = SP.rate_encode(keys[1], torch.sigmoid(x), cfg.T)
    s = _run_blocks(params, s, cfg, keys[2], causal=True, backend=backend)
    return linear(params["head"], SP.rate_decode(s.to(torch.float32)),
                  aimc_cfg, keys[3])
