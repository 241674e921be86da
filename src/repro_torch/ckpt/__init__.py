"""Checkpointing: atomic, async, keep-k, reshard-on-restore."""

from repro_torch.ckpt.manager import CheckpointManager

__all__ = ["CheckpointManager"]
