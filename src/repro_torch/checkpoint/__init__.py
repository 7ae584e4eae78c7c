"""Checkpoints of nested dicts of tensors, sharded or not (PyTorch port of
``repro.checkpoint``)."""

from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    reshard,
)
