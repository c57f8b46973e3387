"""In-context MIMO symbol detection (paper §VI, Task 2): a twin of
``repro.data.icl_mimo``.

A decoder sees ``pairs`` query/answer pairs (received signal ``y``,
transmitted QPSK symbol class ``x``) drawn from one random channel ``H``,
then detects the symbol of a last query.  Query tokens hold ``[Re y, Im
y, 0]``, answer tokens ``[0, 0, one-hot(class)]``; labels and the mask sit
on the query positions.  The draws come from an explicit
``torch.Generator`` with the reference's distributions (the features are
data, not spikes); :func:`class_bits` and :func:`ber` are the reference's
exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Union

import torch

from repro_torch.data.synthetic_images import generator

Tensor = torch.Tensor

_QPSK = torch.tensor([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j],
                     dtype=torch.complex64) / math.sqrt(2.0)


@dataclasses.dataclass(frozen=True)
class MIMOConfig:
    n_tx: int = 2
    n_rx: int = 2
    pairs: int = 18
    snr_db: float = 20.0

    @property
    def n_classes(self) -> int:
        return 4 ** self.n_tx

    @property
    def feat_dim(self) -> int:
        return 2 * self.n_rx + self.n_classes

    @property
    def seq_len(self) -> int:
        return 2 * self.pairs + 1

    @property
    def bits_per_symbol(self) -> int:
        return 2 * self.n_tx


def _symbols_of_class(cls: Tensor, n_tx: int) -> Tensor:
    """Class index -> per-antenna QPSK symbols ``[..., n_tx]`` complex."""
    idx = torch.stack([(cls // (4 ** i)) % 4 for i in range(n_tx)], dim=-1)
    return _QPSK[idx]


def class_bits(cls: Tensor, n_tx: int) -> Tensor:
    """The ``2 n_tx``-bit labelling of a class index."""
    return torch.stack([(cls // (2 ** i)) % 2 for i in range(2 * n_tx)],
                       dim=-1)


def _complex_normal(gen: torch.Generator, shape) -> Tensor:
    return torch.complex(torch.randn(shape, generator=gen),
                         torch.randn(shape, generator=gen))


def sample_batch(seed_or_gen: Union[int, torch.Generator], cfg: MIMOConfig,
                 batch: int, device: Union[str, torch.device] = "cpu"
                 ) -> Dict[str, Tensor]:
    """``{"features": [B,L,F] f32, "labels": [B,L] int64, "mask": [B,L]
    f32}`` with ``L = 2 pairs + 1``, drawn on the CPU and moved to
    ``device``."""
    gen = generator(seed_or_gen)
    n_tok = cfg.pairs + 1
    h = _complex_normal(gen, (batch, cfg.n_rx, cfg.n_tx)) / math.sqrt(
        2.0 * cfg.n_tx)
    cls = torch.randint(0, cfg.n_classes, (batch, n_tok), generator=gen)
    x = _symbols_of_class(cls, cfg.n_tx)  # [B, n_tok, n_tx]
    noise_std = math.sqrt(10.0 ** (-cfg.snr_db / 10.0) / 2.0)
    w = noise_std * _complex_normal(gen, (batch, n_tok, cfg.n_rx))
    y = torch.einsum("brt,bnt->bnr", h, x) + w  # [B, n_tok, n_rx]

    yfeat = torch.cat([y.real, y.imag], dim=-1)
    onehot = torch.nn.functional.one_hot(cls, cfg.n_classes).to(torch.float32)
    feats = torch.zeros((batch, cfg.seq_len, cfg.feat_dim))
    feats[:, 0::2, :2 * cfg.n_rx] = yfeat  # queries at even positions
    feats[:, 1::2, 2 * cfg.n_rx:] = onehot[:, :-1]  # answers
    labels = torch.zeros((batch, cfg.seq_len), dtype=torch.int64)
    labels[:, 0::2] = cls
    mask = torch.zeros((batch, cfg.seq_len))
    mask[:, 0::2] = 1.0
    return {"features": feats.to(device), "labels": labels.to(device),
            "mask": mask.to(device)}


def ber(logits: Tensor, labels: Tensor, mask: Tensor, cfg: MIMOConfig
        ) -> Tensor:
    """Bit error rate over the masked (query) positions."""
    pred = torch.argmax(logits, dim=-1)
    pb = class_bits(pred, cfg.n_tx)
    tb = class_bits(labels, cfg.n_tx)
    errs = torch.sum(torch.abs(pb - tb), dim=-1).to(torch.float32)
    return torch.sum(errs * mask) / (torch.sum(mask) * cfg.bits_per_symbol)
