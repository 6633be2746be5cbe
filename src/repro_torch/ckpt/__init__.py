"""Integrity-checked, retention-managed checkpoints (the reference's
on-disk layout)."""
from repro_torch.ckpt.checkpoint import (  # noqa: F401
    CheckpointManager, latest_step, restore, save,
)
