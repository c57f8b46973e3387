"""Xpikeformer paper-scale configs (Tables III & IV).

Copies of ``repro.configs.xpikeformer``, two families:

* :data:`SPIKING_ARCHS` -- the paper models the engine runs (spiking ViT
  encoders 4-384 / 6-512 / 8-768 for image classification, spiking GPT
  decoders 4-256 / 8-512 for ICL wireless symbol detection), each with a
  ``-smoke`` variant sized for CPU tests, and the aliases
  ``xpikeformer-vit`` / ``xpikeformer-gpt``.  Values are ``(task,
  SpikingConfig)``.
* :func:`xpikeformer_gpt` -- the GPT decoders on the generic LM stack
  (head width 64, ``d_ff = 4 d``, vocab 64, ``T = 4``, SSA attention), as
  the serving path runs them.
"""

from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.spiking_transformer import SpikingConfig


def xpikeformer_gpt(depth: int, dim: int, *, vocab: int, T: int = 4,
                    spiking: bool = True, attention_kind: str = "ssa"
                    ) -> ModelConfig:
    return ModelConfig(
        name=f"xpikeformer-gpt-{depth}-{dim}",
        family="dense",
        num_layers=depth,
        d_model=dim,
        num_heads=max(dim // 64, 1),
        num_kv_heads=max(dim // 64, 1),
        head_dim=64,
        d_ff=4 * dim,
        vocab_size=vocab,
        norm_type="layernorm",
        act="gelu",
        gated_mlp=False,
        spiking=spiking,
        spike_T=T,
        attention_kind=attention_kind,
        rope_theta=10000.0,
        dtype="float32",
    ).validate()


GPT_4_256 = xpikeformer_gpt(4, 256, vocab=64)
GPT_8_512 = xpikeformer_gpt(8, 512, vocab=64)


# ICL MIMO symbol-detection input interface (2x2 antennas, QPSK):
# feat_dim = 2*n_rx + n_classes, vocab = n_classes (data/icl_mimo.py).
_MIMO_FEAT_DIM = 2 * 2 + 16
_MIMO_CLASSES = 16


def _vit(depth: int, dim: int, *, T: int = 4, image_size: int = 32,
         patch_size: int = 4, num_classes: int = 10) -> SpikingConfig:
    return SpikingConfig(
        depth=depth, dim=dim, num_heads=max(dim // 64, 2), T=T, mode="ssa",
        image_size=image_size, patch_size=patch_size, num_classes=num_classes,
    )


def _gpt(depth: int, dim: int, *, T: int = 4) -> SpikingConfig:
    return SpikingConfig(
        depth=depth, dim=dim, num_heads=max(dim // 64, 2), T=T, mode="ssa",
        input_dim=_MIMO_FEAT_DIM, vocab=_MIMO_CLASSES,
    )


SPIKING_ARCHS: Dict[str, Tuple[str, SpikingConfig]] = {
    # paper scales (Tables III / IV)
    "xpikeformer-vit-4-384": ("vit", _vit(4, 384)),
    "xpikeformer-vit-6-512": ("vit", _vit(6, 512)),
    "xpikeformer-vit-8-768": ("vit", _vit(8, 768)),
    "xpikeformer-gpt-4-256": ("gpt", _gpt(4, 256)),
    "xpikeformer-gpt-8-512": ("gpt", _gpt(8, 512)),
    # reduced scales for CPU smoke tests
    "xpikeformer-vit-smoke": (
        "vit", _vit(1, 32, T=3, image_size=16, patch_size=4)),
    "xpikeformer-gpt-smoke": ("gpt", _gpt(1, 32, T=3)),
}

# default aliases
SPIKING_ARCHS["xpikeformer-vit"] = SPIKING_ARCHS["xpikeformer-vit-4-384"]
SPIKING_ARCHS["xpikeformer-gpt"] = SPIKING_ARCHS["xpikeformer-gpt-4-256"]
