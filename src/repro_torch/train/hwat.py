"""Two-stage Xpikeformer training (paper Sec. V-A): a twin of
``repro.train.hwat``.

1. Conventional training (CT): the ideal float forward and backward, with
   surrogate gradients for the spikes and straight-through samplers.
2. Hardware-aware training (HWAT): quantisation and PCM programming noise
   in the forward (:func:`repro_torch.core.aimc.hwat_weights`, one draw a
   linear a forward), the ideal backward.

Then :func:`train_and_program` programs the trained weights onto
simulated PCM (:func:`repro_torch.aimc_device.program_tree`), ready for
the drift lifecycle.  Generic over the paper models: the caller supplies
``forward(params, batch, sim, rng) -> logits`` (:func:`model_forward`
makes one on the float reference backend, which autograd trains through)
and ``data_fn(key) -> batch``.  AdamW is :mod:`repro_torch.optim.adamw`.
Step ``i`` of a stage draws its batch key and forward key from
``split(fold_in(PRNGKey(seed), i))``, as the reference does.  Training
runs where the parameters are: the card, unless they were made on the
CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch import tree as TR
from repro_torch.core.aimc import AIMCConfig
from repro_torch.core.spiking_transformer import AIMCSim
from repro_torch.optim import adamw as A
from repro_torch.train.loop import value_and_grad

Tensor = torch.Tensor


def xent_loss(logits: Tensor, labels: Tensor,
              mask: Optional[Tensor] = None) -> Tensor:
    """Mean cross-entropy in f32 (over ``mask``'s weight where given)."""
    lf = logits.to(torch.float32)
    nll = torch.logsumexp(lf, -1) - torch.take_along_dim(
        lf, labels[..., None].long(), dim=-1)[..., 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def model_forward(cfg, task: Optional[str] = None, backend="reference"):
    """``forward(params, batch, sim, rng) -> logits`` of a paper model
    (``task`` ``"vit"``: ``batch["images"]``; ``"gpt"``:
    ``batch["features"]``; by default from the config) on ``backend``;
    the key moves to the parameters' device."""
    from repro_torch.core import spiking_transformer as ST
    from repro_torch.engine import get_backend

    be = get_backend(backend)
    task = task or ("gpt" if cfg.input_dim > 0 else "vit")
    fwd, field = ((ST.vit_forward, "images") if task == "vit"
                  else (ST.gpt_forward, "features"))

    def forward(params, batch, sim, rng):
        x = batch[field]
        return fwd(params, x, cfg, rng.to(x.device), backend=be, sim=sim)

    return forward


def data_seed(key: Tensor) -> int:
    """A 32-bit seed from a key, for the data twins (which draw from a
    ``torch.Generator``)."""
    return int(prng.random_bits(key.cpu(), (1,))[0])


def make_step(forward: Callable, opt: A.AdamWConfig, sim: AIMCSim):
    """``step(params, opt_state, batch, rng) -> (params, opt_state,
    loss)``: the loss of ``forward`` against ``batch["labels"]`` (over
    ``batch["mask"]`` where given), its gradient and one AdamW update."""
    def loss_fn(params, batch, rng):
        logits = forward(params, batch, sim, rng)
        return xent_loss(logits, batch["labels"], batch.get("mask")), {}

    grad_f = value_and_grad(loss_fn)

    def step(params, opt_state, batch, rng):
        (loss, _), grads = grad_f(params, batch, rng)
        params, opt_state, _ = A.apply_updates(params, grads, opt_state, opt)
        return params, opt_state, loss

    return step


def train_stage(params, forward: Callable, data_fn: Callable[[Tensor], Any],
                *, steps: int, sim: AIMCSim, lr: float = 1e-3, seed: int = 0,
                log_every: int = 0) -> Tuple[Any, List[float]]:
    """One training stage of ``steps`` AdamW steps (warmup ``steps //
    20``, cosine decay, weight decay 0.01, clip 1.0) -> ``(params,
    losses)``; ``data_fn(key)`` makes step ``i``'s batch."""
    opt = A.AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 1),
                        total_steps=steps, weight_decay=0.01, grad_clip=1.0)
    opt_state = A.init_opt_state(params, opt)
    step = make_step(forward, opt, sim)
    key = prng.PRNGKey(seed)
    losses: List[float] = []
    for i in range(steps):
        kd, kf = prng.split(prng.fold_in(key, i))
        params, opt_state, loss = step(params, opt_state, data_fn(kd), kf)
        losses.append(float(loss))
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"  step {i:4d} loss {losses[-1]:.4f}", flush=True)
    return params, losses


def two_stage_train(params, forward: Callable, data_fn: Callable, *,
                    ct_steps: int, hwat_steps: int,
                    aimc_cfg: Optional[AIMCConfig] = None, lr: float = 1e-3,
                    seed: int = 0, log_every: int = 0
                    ) -> Tuple[Any, Dict[str, List[float]]]:
    """CT (ideal weights) from ``seed``, then HWAT (noisy forward) at
    ``0.3 lr`` from ``seed + 1`` -> ``(params, {"ct", "hwat"} losses)``."""
    cfg = aimc_cfg or AIMCConfig()
    params, l1 = train_stage(params, forward, data_fn, steps=ct_steps,
                             sim=AIMCSim(wmode="ideal", cfg=cfg), lr=lr,
                             seed=seed, log_every=log_every)
    l2: List[float] = []
    if hwat_steps > 0:
        params, l2 = train_stage(params, forward, data_fn, steps=hwat_steps,
                                 sim=AIMCSim(wmode="hwat", cfg=cfg),
                                 lr=lr * 0.3, seed=seed + 1,
                                 log_every=log_every)
    return params, {"ct": l1, "hwat": l2}


def train_and_program(params, forward: Callable, data_fn: Callable, *,
                      ct_steps: int, hwat_steps: int,
                      program_key: Optional[Tensor] = None,
                      aimc_cfg: Optional[AIMCConfig] = None, lr: float = 1e-3,
                      seed: int = 0, log_every: int = 0):
    """The paper's pipeline: CT, HWAT, then programming onto PCM with
    ``program_key`` (default ``PRNGKey(seed + 2)``) -> ``(programmed
    params, curves)``: every linear an :class:`repro_torch.aimc_device.
    AIMCDeviceState` at t = 0, ready for ``drift_to`` / ``recalibrate``."""
    from repro_torch import aimc_device as AD

    cfg = aimc_cfg or AIMCConfig()
    params, curves = two_stage_train(
        params, forward, data_fn, ct_steps=ct_steps, hwat_steps=hwat_steps,
        aimc_cfg=cfg, lr=lr, seed=seed, log_every=log_every)
    key = prng.PRNGKey(seed + 2) if program_key is None else program_key
    dev = TR.flatten(params)[0][0].device
    return AD.program_tree(key.to(dev), params, cfg), curves
