"""Fault-tolerant checkpoints of the port (twin of ``repro.checkpoint``)."""

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
