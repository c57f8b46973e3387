"""What one rank of a ``(data, model)`` mesh holds of the serving state.

Twin of the parts of ``repro/parallel/sharding.py`` the executor uses
(``batch_pspec``, ``cache_pspecs``), written as shapes
instead of PartitionSpecs: decode slots split over ``data`` in contiguous
blocks (rank ``d`` holds slots ``[d * slots/D, (d+1) * slots/D)``), the
spiking KV-head axis of the cache and of the page pool splits over
``model`` (each rank caches its own heads' trains), the cache length and
the page axis never split (pages are global: any slot may read any
page), and the pool is whole on every rank of a data group.
"""

from __future__ import annotations

def local_slots(slots: int, data: int) -> int:
    """Decode slots one rank holds: ``slots / data``; ``slots`` must split
    evenly (a rank's decode step computes exactly its own slots)."""
    if slots % data:
        raise ValueError(f"{slots} slots do not split over data={data} "
                         "ranks: use a multiple of the data axis")
    return slots // data


def slot_range(slots: int, data: int, index: int) -> range:
    """The global slots data rank ``index`` holds."""
    n = local_slots(slots, data)
    return range(index * n, (index + 1) * n)


def local_kv_heads(cfg, model: int) -> int:
    """KV heads one rank caches: ``num_kv_heads / model``."""
    if cfg.num_kv_heads % model:
        raise ValueError(f"{cfg.num_kv_heads} KV heads do not split over "
                         f"model={model} ranks")
    return cfg.num_kv_heads // model
