"""The LM stack's train step: a twin of ``repro.train.loop``.

``make_train_step(cfg, parallel, opt)`` returns ``train_step(params,
opt_state, batch, rng) -> (params, opt_state, metrics)``: the next-token
loss of :func:`repro_torch.models.transformer.loss_fn` (a spiking stack
on the float reference backend, the one autograd trains through:
straight-through samplers and surrogate spikes; a float stack as it is,
drawing nothing from ``rng``), its gradient, and an AdamW update
(:mod:`repro_torch.optim.adamw`).  Options, as the reference reads them
from a :class:`repro_torch.configs.base.ParallelConfig`:

* ``microbatches`` -- the batch cut into that many row blocks, one
  gradient each from the keys ``split(rng, n)``, summed in bfloat16 (the
  reference's accumulator) and divided by ``n``;
* ``grad_dtype="bfloat16"`` -- the gradients cast before the update;
* ``grad_compression`` -- the EF-int8 round trip
  (:mod:`repro_torch.optim.compression`), its residuals in
  ``opt_state["ef"]``;
* ``remat`` -- each layer recomputed in the backward.

On a data-parallel mesh (``mesh``, a :class:`repro_torch.launch.mesh.
ServingMesh` of shape ``(data, 1)``) every rank holds the whole state and
the whole batch, and computes the loss and gradient of its rows
(``MarkovStream.host_slice``'s block), drawn as the whole batch draws them;
the loss and the gradients are summed over the data group in one
``all_reduce`` and divided by ``data``, so the AdamW update is the same on
every rank.  ``model > 1`` raises: model-parallel training is not ported
(ROADMAP A2(c)); so does a MoE config on any mesh (ROADMAP A2(c)).

Parameters and state live on the card unless the caller asks for the CPU
(:func:`init_state`); the step runs where they are.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch import prng
from repro_torch import tree as TR
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.aimc import mul_reciprocal
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.optim import compression as C

Tensor = torch.Tensor


def value_and_grad(fn: Callable[..., Tuple[Tensor, Any]]):
    """``fn(params, *args) -> (loss, aux)`` -> a function returning
    ``((loss, aux), grads)``, the gradients a tree of ``params``'
    structure (zeros where a leaf does not reach the loss), detached like
    the loss and ``aux``."""
    def run(params, *args):
        leaves, structure = TR.flatten(params)
        live = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            loss, aux = fn(TR.unflatten(structure, live), *args)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        aux = TR.tree_map(lambda t: t.detach(), aux)
        return (loss.detach(), aux), TR.unflatten(structure, grads)

    return run


def _differentiable(backend):
    from repro_torch.engine import get_backend

    be = get_backend(backend)
    if not getattr(be, "differentiable", False):
        raise ValueError(f"training needs a differentiable backend, not "
                         f"{be.name!r} (use 'reference')")
    return be


def make_loss(cfg, parallel: ParallelConfig = ParallelConfig(),
              backend="reference", rows=None):
    """``loss_f(params, batch, rng) -> (loss, {"xent", "moe_aux"})`` on
    ``backend`` (the reference backend: autograd trains through it);
    ``rows = (b0, n)``: over those rows of the batch only; MoE blocks run
    ``parallel.moe_impl``, their load-balancing loss mixed in."""
    be = _differentiable(backend)

    def loss_f(params, batch, rng):
        return T.loss_fn(params, batch, cfg, rng=rng, backend=be,
                         remat=parallel.remat, rows=rows,
                         moe_impl=parallel.moe_impl)

    return loss_f


def data_rows(mesh, global_batch: int):
    """``(b0, n)``: the batch rows data rank ``mesh.data_index`` trains on
    (``MarkovStream.host_slice``'s block), or ``None`` off a mesh.  Raises
    on a model axis (ROADMAP A2(c)) or a batch the data axis does not
    split."""
    if mesh is None or mesh.data * mesh.model == 1:
        return None
    if mesh.model > 1:
        raise NotImplementedError(
            f"a training mesh of model={mesh.model}: model-parallel "
            "training is not ported (ROADMAP A2(c)); the float reference "
            "backend has no sharded form")
    if global_batch % mesh.data:
        raise ValueError(f"a batch of {global_batch} does not split over "
                         f"data={mesh.data} ranks")
    n = global_batch // mesh.data
    return mesh.data_index * n, n


def _data_mean(mesh, loss: Tensor, grads):
    """The loss and gradients summed over the data group (one
    ``all_reduce`` of a flat float32 buffer) and divided by ``data``."""
    leaves, structure = TR.flatten(grads)
    flat = torch.cat([loss.reshape(1).to(torch.float32)]
                     + [g.reshape(-1).to(torch.float32) for g in leaves])
    flat = mesh.all_reduce_data(flat.to(mesh.host_device)).to(loss.device)
    flat = flat * (1.0 / mesh.data)  # XLA's product with the reciprocal
    out, at = [], 1
    for g in leaves:
        out.append(flat[at:at + g.numel()].reshape(g.shape).to(g.dtype))
        at += g.numel()
    return flat[0].to(loss.dtype), TR.unflatten(structure, out)


def _split_microbatches(batch: Dict[str, Tensor], n: int, i: int
                        ) -> Dict[str, Tensor]:
    return {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
            for k, v in batch.items()}


def make_train_step(cfg, parallel: ParallelConfig = ParallelConfig(),
                    opt: A.AdamWConfig = A.AdamWConfig(),
                    backend="reference", mesh=None) -> Callable:
    """The train step (see the module docstring); ``rng`` is a key of the
    threefry twin.  ``mesh``: the data-parallel step of this rank, given
    the whole batch."""
    dp = data_rows(mesh, mesh.data) is not None if mesh is not None else False
    if dp:
        T.require_mesh_supported(cfg)
    if dp and parallel.microbatches > 1:
        raise NotImplementedError(
            "microbatches on a data-parallel mesh are not ported: a rank's "
            "microbatch would not be one device's")
    grad_f = value_and_grad(make_loss(cfg, parallel, backend))

    def train_step(params, opt_state, batch, rng):
        leaves, _ = TR.flatten(params)
        rng = rng.to(leaves[0].device)
        nmb = parallel.microbatches
        metrics: Dict[str, Tensor] = {}
        if dp:
            rows = data_rows(mesh, batch["tokens"].shape[0])
            (loss, _), grads = value_and_grad(
                make_loss(cfg, parallel, backend, rows))(params, batch, rng)
            loss, grads = _data_mean(mesh, loss, grads)
        elif nmb > 1:
            keys = prng.split(rng, nmb)
            grads = TR.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.bfloat16, device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=rng.device)
            for i in range(nmb):
                (loss, _), g = grad_f(params, _split_microbatches(
                    batch, nmb, i), keys[i])
                grads = TR.tree_map(lambda a, b: a + b.to(a.dtype), grads, g)
                loss_sum = loss_sum + loss
            # XLA's products with the reciprocal (the step is jitted)
            inv = 1.0 / nmb
            grads = TR.tree_map(lambda g: g * torch.tensor(
                inv, dtype=g.dtype, device=g.device), grads)
            loss = mul_reciprocal(loss_sum, nmb)
        else:
            (loss, metrics), grads = grad_f(params, batch, rng)
        if parallel.grad_dtype == "bfloat16":
            grads = TR.tree_map(lambda g: g.to(torch.bfloat16), grads)
        if parallel.grad_compression:
            grads, new_ef = C.compress_decompress(grads, opt_state["ef"])
        params, new_state, om = A.apply_updates(params, grads, opt_state, opt)
        if parallel.grad_compression:
            new_state["ef"] = new_ef
        return params, new_state, {"loss": loss, **om, **metrics}

    return train_step


def init_state(seed: int, cfg, opt: A.AdamWConfig = A.AdamWConfig(),
               parallel: ParallelConfig = ParallelConfig(),
               device: Union[str, torch.device, None] = None):
    """Random parameters from ``seed`` (:func:`repro_torch.models.
    transformer.init_params`) and their AdamW state (plus the EF
    residuals under ``grad_compression``), on ``device`` (the card unless
    the caller asks for the CPU)."""
    params = T.init_params(cfg, seed, resolve_device(device))
    opt_state = A.init_opt_state(params, opt)
    if parallel.grad_compression:
        opt_state["ef"] = C.init_ef_state(params)
    return params, opt_state
