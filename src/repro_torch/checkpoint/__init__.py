"""Atomic checkpoints in the reference's on-disk layout."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    incremental_embedding_update,
    latest_step,
)
