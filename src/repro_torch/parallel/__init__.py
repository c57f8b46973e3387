"""Per-rank shapes of the ``(data, model)`` serving mesh."""
