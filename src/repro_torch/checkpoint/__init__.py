"""Checkpoints in the reference's on-disk format, and the elastic restart."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    MeshCheckpointManager,
    restore_pytree,
    save_pytree,
)
from repro_torch.checkpoint.reshard import reshard_to_mesh  # noqa: F401
