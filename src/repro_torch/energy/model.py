"""Event-level energy metering: measured spike counts x Table-II op energies.

The metering half of ``repro.energy.model`` (lines 167-296), copied: the
:class:`EnergyReport` of one metered forward, the per-call meters of the
spiking linear and the SSA tile, and the per-event and static per-token
energies the serving scheduler books against each request.  The
analytical four-design model of the same module (``energy_ann_quant`` ...
``area_xpikeformer_mm2``, Fig. 8-10 and Table VI) goes with the
benchmark twins (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.energy import constants as C


@dataclasses.dataclass
class EnergyReport:
    """Accumulated energy of one metered forward (picojoules per component).

    ``spikes_in`` / ``spikes_out`` are the measured spike-event counts into
    and out of the metered primitives — the quantities the event-driven
    terms scale with."""

    aimc_pj: float = 0.0
    ssa_pj: float = 0.0
    lif_pj: float = 0.0
    spikes_in: float = 0.0
    spikes_out: float = 0.0
    calls: int = 0

    @property
    def total_pj(self) -> float:
        return self.aimc_pj + self.ssa_pj + self.lif_pj

    @property
    def total_j(self) -> float:
        return self.total_pj * 1e-12

    def as_dict(self) -> Dict[str, float]:
        return {
            "aimc_pj": self.aimc_pj, "ssa_pj": self.ssa_pj,
            "lif_pj": self.lif_pj, "total_pj": self.total_pj,
            "total_j": self.total_j, "spikes_in": self.spikes_in,
            "spikes_out": self.spikes_out, "calls": float(self.calls),
        }


def meter_spiking_linear(t_steps: int, tokens: int, d_in: int, d_out: int,
                         in_spikes: float) -> Dict[str, float]:
    """Energy (pJ) of one spiking-linear call through the AIMC tiles.

    Tile reads happen once per (timestep, token) per 128x128 tile; the
    analog array term is event-driven (word lines pulse only on input
    spikes, so it scales with the measured input rate) while ADC /
    accumulation / periphery run every read.  LIF fires per output neuron
    per timestep."""
    tiles = math.ceil(d_in / C.XBAR) * math.ceil(d_out / C.XBAR)
    reads = tiles * t_steps * tokens
    in_rate = in_spikes / max(t_steps * tokens * d_in, 1)
    aimc = reads * (
        C.E_XBAR_TILE_READ * in_rate
        + C.ADC_PER_TILE * C.E_ADC_CONV + C.E_ACCUM_TILE + C.E_PERIPH_TILE
    )
    lif = t_steps * tokens * d_out * C.E_LIF_STEP
    return {"aimc": aimc, "lif": lif}


def meter_ssa(t_steps: int, groups: int, n: int, l: int, d: int,
              q_rate: float, k_rate: float, v_rate: float) -> Dict[str, float]:
    """Energy (pJ) of one SSA attention call (score + output stages).

    AND gates evaluate every (query, key, channel) triple; the ripple
    counters increment only on AND-true events, estimated from the measured
    operand rates (independent-operand approximation; the score-spike rate
    entering the output stage is taken as the comparator median 0.5).
    Comparators fire once per score / output element; the shared 32-bit
    LFSR amortises over 4 tapped bytes."""
    evals = t_steps * groups * n * l * d
    and_gates = 2 * evals * C.E_AND
    counters = evals * (q_rate * k_rate + 0.5 * v_rate) * C.E_CNT8
    comps = t_steps * groups * (n * l + n * d) * C.E_CMP8
    lfsr = t_steps * groups * (n * l + n * d) / 4.0 * C.E_LFSR32
    return {"ssa": and_gates + counters + comps + lfsr}


def decode_synapse_energy_pj() -> float:
    """Energy per residual-stream spike event in the serving decode path.

    The per-event cost a cached spike contributes downstream: one crossbar
    word-line pulse across the row's tiles plus the SSA AND/counter work it
    gates.  Used with *measured* per-slot spike counts from the jitted
    ``decode_step`` (which cannot host-meter per call) to apportion a
    request's event-driven energy."""
    return C.E_XBAR_TILE_READ + C.E_AND + C.E_CNT8


def lm_decode_token_energy_pj(d_model: int, n_heads: int, head_dim: int,
                              d_ff: int, depth: int, spike_T: int,
                              cache_len: int, vocab: int) -> float:
    """Static (activity-independent) energy per decoded token (pJ).

    The per-read ADC / accumulation / periphery and per-neuron LIF terms of
    the six spiking matrices of each block, plus the SSA comparator / LFSR
    banks over the cache — everything that runs whether or not a given
    synapse spikes.  The event-driven remainder is added from measured
    spike counts via :func:`decode_synapse_energy_pj`."""
    d_attn = n_heads * head_dim

    def tile_reads(d_in, d_out):
        return math.ceil(d_in / C.XBAR) * math.ceil(d_out / C.XBAR) * spike_T

    reads = depth * (
        3 * tile_reads(d_model, d_attn) + tile_reads(d_attn, d_model)
        + tile_reads(d_model, d_ff) + tile_reads(d_ff, d_model)
    )
    aimc = reads * (C.ADC_PER_TILE * C.E_ADC_CONV + C.E_ACCUM_TILE
                    + C.E_PERIPH_TILE)
    lif = depth * spike_T * (2 * d_attn + 2 * d_model + d_ff + d_model) * C.E_LIF_STEP
    ssa = depth * spike_T * n_heads * (
        (cache_len + head_dim) * C.E_CMP8
        + (cache_len + head_dim) / 4.0 * C.E_LFSR32
    )
    head = d_model * vocab * C.E_MAC_FF  # digital unembed
    return aimc + lif + ssa + head
