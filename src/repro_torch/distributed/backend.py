"""ShardedBackend: the tensor-parallel spiking primitives of one mesh rank.

Twin of ``repro/distributed/backend.py``.  Where JAX wraps each primitive
in ``shard_map`` over the whole mesh, the port runs one process per rank,
and this backend computes that rank's share and names the collectives:

* **column-parallel spiking linear** (``part="col"``: Q/K/V, MLP in) --
  the rank holds its columns of the crossbar (quantised on the whole
  matrix, so its levels and scales are the whole matrix's) and fires its
  own LIF columns with no communication.  The output stays split: its
  heads feed the head-parallel attention, its MLP columns the row-parallel
  MLP out (the Megatron layout);
* **row-parallel spiking linear** (``part="row"``: attention out, MLP out)
  -- the rank counts over its input rows (K5: the inner backend's
  ``crossbar_counts``), the integer-valued f32 counts are summed over the
  model group (exact in any order below 2**24), then ``counts * scale``,
  ``+ b`` (two separate roundings, as in K1) and the LIF fire once on the
  whole sum, in one pass (the inner backend's ``counts_lif``: K4's counts
  entry on the card): the same spikes as the single-device linear, bit
  for bit;
* **head-parallel SSA tile** (the full-sequence forward) -- the rank's
  heads of the keyed K8, drawing at its global head offset, as the decode
  does;
* **head-parallel SSA decode** -- the rank attends over its own heads
  (its KV heads of the cache or page pool), drawing the comparator
  integers of the ``f(seed, pos, head)`` streams at its global head offset
  ``h0 + model_index * h_local``, exactly the integers one device draws
  for those heads;
* **head-parallel fused layer** -- the inner backend's layer kernel (K3 /
  K9) over the rank's heads with ``with_tail=False``, then the tail
  through the row- and column-parallel linears above.

The residual stream is whole on every rank of a model group.  A block part
that does not split (:class:`TPPlan`: heads that ``model`` does not
divide, a ``d_ff`` it does not divide) is held whole on every rank and
computed whole there, with no collective: all heads at head offset 0, a
row-parallel linear of a part held whole without its sum (the caller
names the part, ``group``).  Spikes are integer data, so the result is
one device's bit for bit either way.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import engine as E

# which spiking-linear leaves are column- vs row-parallel (Megatron layout:
# the paper's per-head SSA cores and column-tiled crossbars)
TP_PARTS = {"wq": "col", "wk": "col", "wv": "col", "wi": "col", "wo": "row"}


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """What the ``model`` axis splits for a config: shared by parameter
    placement (:func:`repro_torch.convert.shard_params`,
    :func:`repro_torch.parallel.sharding.param_placement`) and
    :class:`ShardedBackend`, so the two agree.  The reference's per-leaf
    rule (``col_ok``/``row_ok``, an attention's ``heads``), taken a block
    part at a time: the attention's four linears split when its heads do
    (its heads stay whole on each rank), the MLP's two when ``d_ff`` does;
    a part that does not split is held whole and computed whole on every
    rank of the model group.  (Where the heads do not split, the
    reference still cuts Q/K/V and the attention out by their widths and
    gathers between them; the port holds the part whole: the same
    values.)"""

    tp: int = 1  # model-axis size
    heads: bool = False  # h % tp == 0 and kv % tp == 0: SSA cores split
    mlp: bool = False  # d_ff % tp == 0: the MLP's columns and rows split

    @classmethod
    def from_config(cls, cfg, tp: int) -> "TPPlan":
        if tp <= 1:
            return cls()
        nh = getattr(cfg, "num_heads", 0) or 0
        kv = getattr(cfg, "num_kv_heads", 0) or 0
        return cls(tp=tp, heads=nh > 0 and nh % tp == 0 and kv % tp == 0,
                   mlp=cfg.d_ff > 0 and cfg.d_ff % tp == 0)

    def splits(self, group: str) -> bool:
        """Whether the block part ``"mixer"`` (the attention) or ``"mlp"``
        is cut over the model group."""
        return self.heads if group == "mixer" else self.mlp


def mat_dims(cfg, group: str, name: str):
    """Global ``(d_in, d_out)`` of one spiking linear of the LM stack."""
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    return {("mixer", "wq"): (d, h * hd), ("mixer", "wk"): (d, kv * hd),
            ("mixer", "wv"): (d, kv * hd), ("mixer", "wo"): (h * hd, d),
            ("mlp", "wi"): (d, cfg.d_ff),
            ("mlp", "wo"): (cfg.d_ff, d)}[(group, name)]


class ShardedBackend:
    """One rank's tensor-parallel share of a bit-exact backend (``integer``
    or ``cuda``) on a :class:`repro_torch.launch.mesh.ServingMesh`.  Its
    operands are the rank's shards (:func:`repro_torch.convert.
    shard_params`)."""

    differentiable = False
    bit_exact = True

    def __init__(self, inner, mesh, cfg):
        if not inner.bit_exact:
            raise ValueError(f"the mesh shards a bit-exact backend, not "
                             f"{inner.name!r}")
        self.inner = inner
        self.mesh = mesh
        self.cfg = cfg
        self.plan = TPPlan.from_config(cfg, mesh.model)
        self.name = f"sharded[{inner.name}]"

    # -- head-parallel SSA decode --------------------------------------

    def _h0(self, h0, h_local: int):
        """A call's global head offset: the rank's heads when the heads
        split, all of them (``h0`` itself) when they do not."""
        if not self.plan.heads:
            return h0
        return h0 + self.mesh.model_index * h_local

    # -- head-parallel SSA tile (the full-sequence forward) --------------

    def ssa_attention(self, key, q, k, v, *, causal=False, b0=0,
                      batch=None):
        """The rank's heads ``q [T,B,h_local,N,d]`` of the SSA tile grid:
        the inner keyed tile at the rank's global head offset in a grid of
        ``h_local * model`` heads, so it draws the comparators one device
        draws for those heads."""
        h = q.shape[2]
        if not self.plan.heads:
            return self.inner.ssa_attention(key, q, k, v, causal=causal,
                                            b0=b0, batch=batch)
        return self.inner.ssa_attention(
            key, q, k, v, causal=causal, b0=b0, h0=self._h0(0, h),
            batch=batch, heads=self.plan.tp * h)

    def decode_attention(self, view, q, spec, *, slot_keys):
        """The rank's heads ``q [T,B,h_local,1,d]`` over its KV heads of the
        dense cache or page pool, at its global head offset."""
        sub = dataclasses.replace(spec, h0=self._h0(spec.h0, q.shape[2]))
        return self.inner.decode_attention(view, q, sub, slot_keys=slot_keys)

    # -- head-parallel fused decode layer ------------------------------

    def decode_layer_fused(self, slot_keys, s, view, pos, wq, wk, wv,
                           wo=None, wi=None, wo2=None, *, hd, h0=0,
                           with_tail=True, with_mlp=True, write_pids=None):
        """The inner layer kernel over the rank's heads (``with_tail=
        False``: its attention train and its KV heads' new trains), then
        the tail through the row/column-parallel linears, which commit the
        fused kernel's roundings: the single-device layer's output."""
        levels, _ = E._levels_scale(E._linear_parts(wq))
        off = self._h0(h0, levels.shape[-1] // hd)
        a, k_new, v_new = self.inner.decode_layer_fused(
            slot_keys, s, view, pos, wq, wk, wv, hd=hd, h0=off,
            with_tail=False, write_pids=write_pids)
        if not with_tail:
            return a, k_new, v_new
        s1 = s + self.spiking_linear(wo, a, part="row",
                                     group="mixer").to(torch.float32)
        if with_mlp:
            h1 = self.spiking_linear(wi, s1, part="col").to(torch.float32)
            s1 = s1 + self.spiking_linear(wo2, h1, part="row",
                                          group="mlp").to(torch.float32)
        return s1, k_new, v_new

    # -- tensor-parallel spiking linear --------------------------------

    def spiking_linear(self, p, spikes, *, key=None, sim=None, part=None,
                       group=None):
        """The rank's share of a spiking linear (the digital backends'
        ``key`` and ``sim`` are ignored, as on one device).  A row linear
        sums over the model group when its block part ``group`` is cut
        (``None``: the leaf is a cut row-parallel one)."""
        if part == "row" and (group is None or self.plan.splits(group)):
            return self._row_linear(p, spikes)
        if part not in (None, "col", "row"):
            raise ValueError(f"part must be 'col' or 'row', got {part!r}")
        # columns: the rank's own LIF columns, no communication; a linear
        # held whole runs whole
        return self.inner.spiking_linear(p, spikes, part=part)

    def _row_linear(self, p, spikes):
        """Input rows split: local counts (K5), their sum over the model
        group, then scale, bias and LIF once on the whole sum (one K4
        launch)."""
        parts = E._linear_parts(p)
        levels, scale = E._levels_scale(parts)
        flat, unflatten = E._flatten_time(spikes)
        counts = self.inner.crossbar_counts(
            flat.to(torch.float32).contiguous(), levels.contiguous())
        self.mesh.all_reduce_model(counts)  # exact: integer-valued f32
        # scale, bias and LIF in one pass (K4's counts entry on the card)
        return unflatten(self.inner.counts_lif(counts, scale, parts.get("b")))


class TrainingShardBackend:
    """A training rank's share of the float reference backend
    (``engine.ReferenceBackend``, the one autograd trains through) on a
    ``(data, model)`` mesh: the spiking stack's linears cut as
    :func:`repro_torch.parallel.sharding.train_specs` places them (their
    ZeRO-3 cut over ``data`` is gathered before the block runs:
    :func:`repro_torch.models.transformer._uncut_block`).

    * a column-parallel linear of a cut part (Q/K/V, MLP in) takes its
      input through ``copy_to_model`` (the model group's cotangents
      summed) and fires the rank's own LIF columns;
    * a row-parallel linear of a cut part (attention out, MLP out) sums
      the rank's partial currents over the model group
      (``reduce_from_model``: a float sum split over the group, so not
      one device's bits) and fires the LIF once on the sum;
    * the float SSA draws the rank's heads' comparators where they lie in
      the whole tile's draw (``h0``, ``heads``);
    * where the KV heads are whole over ``model``, the K/V linears take
      the groups the rank's query heads read
      (:func:`repro_torch.models.layers.own_kv_groups`).

    A part the model axis does not cut runs whole on every rank.  Only
    float weights are cut (HWAT's noise and programmed state are drawn
    and read over whole matrices)."""

    differentiable = True
    bit_exact = False

    def __init__(self, inner, mesh, cfg, *, heads: bool, mlp: bool):
        self.inner = inner
        self.mesh = mesh
        self.cfg = cfg
        self.heads = heads
        self.mlp = mlp
        self.name = f"sharded[{inner.name}]"

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def ssa_attention(self, key, q, k, v, *, causal=False, b0=0, h0=0,
                      batch=None, heads=None):
        if self.heads:
            h = q.shape[2]
            h0, heads = self.mesh.model_index * h, self.mesh.model * h
        return self.inner.ssa_attention(key, q, k, v, causal=causal, b0=b0,
                                        h0=h0, batch=batch, heads=heads)

    def spiking_linear(self, p, spikes, *, key=None, sim=None, part=None,
                       group=None):
        cut = self.heads if group == "mixer" else (
            self.mlp if group == "mlp" else False)
        if not cut:
            return self.inner.spiking_linear(p, spikes, key=key, sim=sim,
                                             part=part)
        parts = E._linear_parts(p)
        if "w" not in parts or (sim is not None and sim.wmode != "ideal"):
            raise NotImplementedError(
                "a cut spiking linear trains float weights only: HWAT's "
                "noise and programmed state are drawn over whole matrices")
        if part == "col":
            return self.inner.spiking_linear(
                p, self.mesh.copy_to_model(spikes), key=key, sim=sim,
                part=part)
        from repro_torch.core import spikes as SP

        pre = self.mesh.reduce_from_model(torch.matmul(spikes, parts["w"]))
        if parts.get("b") is not None:
            pre = pre + parts["b"]
        return SP.lif(pre)
