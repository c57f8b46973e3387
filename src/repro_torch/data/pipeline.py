"""The synthetic LM data pipeline: a twin of ``repro.data.pipeline``.

Batches are a pure function of ``(seed, step)`` (counter-based draws, no
iterator state), so a restart at step ``k`` replays batches ``k, k+1,
...`` exactly.  The stream is a learnable order-2 Markov chain over an
active vocabulary of ``min(vocab_size, 512)`` tokens, its transition
logits ``2 gumbel(PRNGKey(seed), (v, v, v))``; a batch is ``[B, S+1]``
int32 tokens, two initial tokens ``randint`` and each next one a
``categorical`` draw from the previous two.  Every draw comes from the
threefry twin with the reference's keys: the uniforms are JAX's bit for
bit, and :func:`MarkovStream.chain` turns given Gumbel noise into the
reference's tokens exactly (the noise itself passes two ``log``s, a float
boundary).  The chain runs where the stream was made (the card unless the
caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Union

import torch

from repro_torch import prng
from repro_torch.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """A copy of ``repro.data.pipeline.DataConfig``."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 2  # markov order


@functools.lru_cache(maxsize=4)
def _chain_logits(v: int, seed: int, device: torch.device) -> Tensor:
    """The chain's transition logits ``[v, v, v]``: ``v**3`` Gumbel draws,
    the stream's costliest part, drawn once a process for each ``(v,
    seed, device)`` (every stream of a run, a restart's included, shares
    them; no caller writes into them)."""
    return prng.gumbel(prng.PRNGKey(seed, device), (v, v, v)) * 2.0


class MarkovStream:
    """Pure-function batch source: ``batch_at(step)`` is deterministic."""

    def __init__(self, cfg: DataConfig,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        v = min(cfg.vocab_size, 512)  # active vocabulary of the chain
        self.logits = _chain_logits(v, cfg.seed, self.device)
        self.v = v

    def noise(self, key: Tensor) -> Dict[str, Tensor]:
        """The draws of one batch: the two initial tokens ``[B, 2]`` from
        ``split(key)[0]`` and the Gumbel noise ``[S+1, B, v]`` of every
        step from ``split(split(key)[1], S+1)``."""
        b, s = self.cfg.global_batch, self.cfg.seq_len + 1
        k = prng.split(key.to(self.device))
        init = prng.randint(k[0], (b, 2), 0, self.v)
        return {"init": init, "gumbel": prng.gumbel(prng.split(k[1], s),
                                                    (b, self.v))}

    def chain(self, init: Tensor, gumbel: Tensor) -> Tensor:
        """The Markov chain from ``init [B, 2]`` with the per-step noise
        ``gumbel [S+1, B, v]`` -> tokens ``[B, S+1]`` int32."""
        t1, t2 = init[:, 0].long(), init[:, 1].long()
        toks = []
        for g in gumbel:
            nxt = torch.argmax(g + self.logits[t1, t2], dim=-1)
            toks.append(nxt)
            t1, t2 = t2, nxt
        return torch.stack(toks, dim=1).to(torch.int32)

    def batch_at(self, step: int) -> Dict[str, Tensor]:
        """Step ``step``'s batch: ``{"tokens": [B, S+1] int32}`` from the
        key ``fold_in(PRNGKey(seed + 1), step)``."""
        key = prng.fold_in(prng.PRNGKey(self.cfg.seed + 1), step)
        return {"tokens": self.chain(**self.noise(key))}

    def host_slice(self, batch: Dict[str, Tensor], host_id: int,
                   num_hosts: int) -> Dict[str, Tensor]:
        """The rows of ``batch`` a data-parallel host of ``num_hosts``
        feeds."""
        per = self.cfg.global_batch // num_hosts
        return {k: x[host_id * per:(host_id + 1) * per]
                for k, x in batch.items()}
