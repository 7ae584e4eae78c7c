"""Checkpoints of nested dicts of tensors (PyTorch port of
``repro.checkpoint``)."""

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
