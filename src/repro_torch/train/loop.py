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

On a ``(data, model)`` mesh (``mesh``, a :class:`repro_torch.launch.mesh.
ServingMesh`) a rank holds its cut of the parameters and of the AdamW
moments (:func:`repro_torch.parallel.sharding.param_placement`, the
reference's rules where the port cuts) and computes on its batch rows
(``MarkovStream.host_slice``'s block of the ``data`` axis; ``pure_dp``:
of every rank), drawn as the whole batch draws them.  The attention and
MLP run on the rank's heads and columns, a MoE block on the rank's
sequence block with the reference's per-device capacities and FSDP
gathers, and the loss is the global batch's (:func:`repro_torch.models.
transformer.loss_fn` with :func:`repro_torch.parallel.sharding.make_pctx`).
Each gradient is then reduced by its leaf's placement: summed over the
ranks that split the rows, except over an axis that cuts the leaf (the
model group computes a whole leaf identically, and a cut leaf's collectives
already summed what reaches it: a column- or row-parallel part through
Megatron's pair, the router through the sum of its sequence blocks, an
FSDP-cut expert or a ZeRO-3 leaf through its gather's backward, the
reduce-scatter over ``data``).  The gradient norm is the global one
(:mod:`repro_torch.optim.adamw`).  ``microbatches > 1`` on a mesh takes
the reference's global microbatches (the batch reshaped to ``[n, B/n]``
before it is split over ``data``), each reduced before the bfloat16
sum; ``grad_compression`` on a cut takes each int8 row's scale over the
whole row, across the ranks that hold it.

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
              backend="reference", rows=None, pctx=None):
    """``loss_f(params, batch, rng) -> (loss, {"xent", "moe_aux"})`` on
    ``backend`` (the reference backend: autograd trains through it);
    ``rows = (b0, n)``: over those rows of the batch only; ``pctx``: a
    training mesh rank's (the loss the global batch's); MoE blocks run
    ``parallel.moe_impl``, their load-balancing loss mixed in."""
    be = _differentiable(backend)

    def loss_f(params, batch, rng):
        return T.loss_fn(params, batch, cfg, rng=rng, backend=be,
                         remat=parallel.remat, rows=rows,
                         moe_impl=parallel.moe_impl, pctx=pctx)

    return loss_f


def data_rows(mesh, global_batch: int, pure_dp: bool = False):
    """``(b0, n)``: the batch rows this rank trains on
    (``MarkovStream.host_slice``'s block of the ``data`` axis; with
    ``pure_dp`` of every rank), or ``None`` where one rank holds them all.
    Raises on a batch the axis does not split."""
    if mesh is None:
        return None
    split = mesh.data * mesh.model if pure_dp else mesh.data
    if split == 1:
        return None
    if global_batch % split:
        raise ValueError(f"a batch of {global_batch} does not split over "
                         f"{split} ranks")
    n = global_batch // split
    return (mesh.rank if pure_dp else mesh.data_index) * n, n


class MeshStep:
    """What a rank's train step needs of its mesh: the context, the
    placement, the (wrapped) backend and each leaf's reduction."""

    def __init__(self, cfg, parallel: ParallelConfig, mesh, backend):
        from repro_torch.distributed.backend import TrainingShardBackend
        from repro_torch.parallel import sharding as SH

        self.mesh = mesh
        self.pure_dp = parallel.pure_dp
        self.pctx = SH.make_pctx(mesh, parallel)
        self.placement = SH.param_placement(
            cfg, mesh.shape, device=mesh.device, data_index=mesh.data_index,
            model_index=mesh.model_index, fsdp=parallel.fsdp,
            pure_dp=parallel.pure_dp)
        specs = SH.train_specs(cfg, mesh.shape, fsdp=parallel.fsdp,
                               pure_dp=parallel.pure_dp)
        heads, mlp = ("model" in SH.block_spec(specs, g, n) for g, n in (
            ("mixer", "wq"), ("mlp", "wi")))
        be = _differentiable(backend)
        self.backend = (TrainingShardBackend(be, mesh, cfg, heads=heads,
                                             mlp=mlp)
                        if cfg.spiking and (heads or mlp) else be)
        self.row_axes = self.pctx.token_axes(False)

    def reduce(self, grads):
        """Each gradient summed over the row axes that do not cut its
        leaf (one float32 ``all_reduce`` a group of leaves); a leaf cut
        over ``data`` was summed by its gather's reduce-scatter."""
        from repro_torch.parallel import sharding as SH

        leaves, structure = TR.flatten(grads)
        places = SH.leaf_placements(grads, self.placement)
        out = list(leaves)
        by_axes: Dict[tuple, list] = {}
        for i, p in enumerate(places):
            axes = tuple(a for a in self.row_axes if a not in p.cut_over)
            by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            if not any(self.mesh.axis_size(a) > 1 for a in axes):
                continue
            flat = self.mesh.all_reduce(torch.cat(
                [leaves[i].reshape(-1).to(torch.float32) for i in idx]), axes)
            at = 0
            for i in idx:
                g = leaves[i]
                out[i] = flat[at:at + g.numel()].reshape(g.shape).to(g.dtype)
                at += g.numel()
        return TR.unflatten(structure, out)

    def cuts(self, params):
        from repro_torch.parallel import sharding as SH

        return SH.leaf_cuts(params, self.placement)


def mesh_loss(cfg, parallel: ParallelConfig, mesh, backend="reference"):
    """``loss_f(params, batch, rng) -> (loss, metrics)`` of a mesh rank
    holding its cut (the global batch's loss, every rank of the mesh
    calling it), or of one device off a mesh."""
    if mesh is None or mesh.data * mesh.model == 1:
        return make_loss(cfg, parallel, backend)
    ms = MeshStep(cfg, parallel, mesh, backend)

    def loss_f(params, batch, rng):
        key = "tokens" if "tokens" in batch else "targets"
        rows = data_rows(mesh, batch[key].shape[0], ms.pure_dp)
        return make_loss(cfg, parallel, ms.backend, rows, ms.pctx)(
            params, batch, rng)

    return loss_f


def _split_microbatches(batch: Dict[str, Tensor], n: int, i: int
                        ) -> Dict[str, Tensor]:
    return {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
            for k, v in batch.items()}


def make_train_step(cfg, parallel: ParallelConfig = ParallelConfig(),
                    opt: A.AdamWConfig = A.AdamWConfig(),
                    backend="reference", mesh=None,
                    donate: bool = False) -> Callable:
    """The train step (see the module docstring); ``rng`` is a key of the
    threefry twin.  ``mesh``: the step of this rank, given the whole
    batch and the rank's cut of the state (:func:`init_state` with the
    same ``mesh``).  ``donate``: the step writes the new parameters and
    moments into the given ones (:func:`repro_torch.optim.adamw.
    apply_updates`), holding one copy of the state."""
    on_mesh = mesh is not None and mesh.data * mesh.model > 1
    ms = MeshStep(cfg, parallel, mesh, backend) if on_mesh else None
    grad_f = value_and_grad(make_loss(cfg, parallel, backend))

    def grad_of(params, batch, rng):
        """``((loss, metrics), grads)`` of ``batch`` (on a mesh: the
        global batch's loss over this rank's rows, each gradient reduced
        to the global one)."""
        if not on_mesh:
            return grad_f(params, batch, rng)
        rows = data_rows(mesh, batch["tokens"].shape[0] if "tokens" in batch
                         else batch["targets"].shape[0], ms.pure_dp)
        out, grads = value_and_grad(make_loss(
            cfg, parallel, ms.backend, rows, ms.pctx))(params, batch, rng)
        return out, ms.reduce(grads)

    def train_step(params, opt_state, batch, rng):
        leaves, _ = TR.flatten(params)
        rng = rng.to(leaves[0].device)
        nmb = parallel.microbatches
        metrics: Dict[str, Tensor] = {}
        cuts = ms.cuts(params) if on_mesh else None
        if nmb > 1:
            # the reference's global microbatches (on a mesh each split
            # over the data ranks in turn), reduced gradients summed in
            # bfloat16
            keys = prng.split(rng, nmb)
            grads = TR.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.bfloat16, device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=rng.device)
            for i in range(nmb):
                (loss, _), g = grad_of(params, _split_microbatches(
                    batch, nmb, i), keys[i])
                grads = TR.tree_map(lambda a, b: a + b.to(a.dtype), grads, g)
                loss_sum = loss_sum + loss
            # XLA's products with the reciprocal (the step is jitted)
            inv = 1.0 / nmb
            grads = TR.tree_map(lambda g: g * torch.tensor(
                inv, dtype=g.dtype, device=g.device), grads)
            loss = mul_reciprocal(loss_sum, nmb)
        else:
            (loss, metrics), grads = grad_of(params, batch, rng)
        if parallel.grad_dtype == "bfloat16":
            grads = TR.tree_map(lambda g: g.to(torch.bfloat16), grads)
        if parallel.grad_compression:
            grads, new_ef = C.compress_decompress(
                grads, opt_state["ef"], cuts=cuts,
                mesh=mesh if on_mesh else None)
        params, new_state, om = A.apply_updates(
            params, grads, opt_state, opt, cuts=cuts,
            mesh=mesh if on_mesh else None, donate=donate)
        if parallel.grad_compression:
            new_state["ef"] = new_ef
        return params, new_state, {"loss": loss, **om, **metrics}

    return train_step


def init_state(seed: int, cfg, opt: A.AdamWConfig = A.AdamWConfig(),
               parallel: ParallelConfig = ParallelConfig(),
               device: Union[str, torch.device, None] = None, mesh=None):
    """Random parameters from ``seed`` (:func:`repro_torch.models.
    transformer.init_params`) and their AdamW state (plus the EF
    residuals under ``grad_compression``), on ``device`` (the card unless
    the caller asks for the CPU).  ``mesh``: this rank's cut of them
    (each leaf drawn only where the rank holds it; the moments' layout,
    int8 or not, decided by the whole leaf), on the mesh's device."""
    if mesh is None or mesh.data * mesh.model == 1:
        params = T.init_params(cfg, seed, resolve_device(device))
        opt_state = A.init_opt_state(params, opt)
        if parallel.grad_compression:
            opt_state["ef"] = C.init_ef_state(params)
        return params, opt_state
    placement = state_placement(cfg, mesh, parallel)
    params = T.init_params(cfg, seed, mesh.device, placement=placement[0])
    like = whole_like(cfg, opt, parallel)[1]
    return params, _zeros_like_pieces(like, placement[1], mesh.device)


def rank_state(cfg, mesh, parallel: ParallelConfig, opt: A.AdamWConfig,
               params, opt_state=None):
    """A training rank's cut of a whole ``params`` tree and of its AdamW
    state (``None``: fresh moments), on the mesh's device."""
    from repro_torch.checkpoint.manager import map_with_placement

    pp, op = state_placement(cfg, mesh, parallel)

    def cut(x, where, field):
        x = x if where.whole else where.piece(x, field)
        return x.contiguous().to(mesh.device)

    like = whole_like(cfg, opt, parallel)[1]
    return (map_with_placement(cut, params, pp),
            _zeros_like_pieces(like, op, mesh.device) if opt_state is None
            else map_with_placement(cut, opt_state, op))


def state_placement(cfg, mesh, parallel: ParallelConfig):
    """``(param placement, opt-state placement)`` of a training rank
    (:func:`repro_torch.launch.elastic.state_shardings`)."""
    from repro_torch.launch import elastic

    return elastic.state_shardings(
        cfg, mesh.shape, None, device=mesh.device, rank=mesh.rank,
        fsdp=parallel.fsdp, pure_dp=parallel.pure_dp)


def whole_like(cfg, opt: A.AdamWConfig = A.AdamWConfig(),
               parallel: ParallelConfig = ParallelConfig()):
    """The whole training state's shapes and dtypes as ``meta`` tensors:
    ``(params, opt_state)``, what a cut rank restores into."""
    params = TR.tree_map(
        lambda shape: torch.empty(shape, dtype=T.model_dtype(cfg),
                                  device="meta"), T._model_shapes(cfg),
        is_leaf=lambda x: isinstance(x, tuple))
    opt_state = A.init_opt_state(params, opt)
    if parallel.grad_compression:
        opt_state["ef"] = C.init_ef_state(params)
    return params, opt_state


def _zeros_like_pieces(like, placement, device):
    from repro_torch.checkpoint.manager import map_with_placement

    def zero(x, where, field):
        piece = x if where.whole else where.piece(x, field)
        return torch.zeros(piece.shape, dtype=x.dtype, device=device)

    return map_with_placement(zero, like, placement)
