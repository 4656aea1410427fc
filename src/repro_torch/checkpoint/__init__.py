"""Checkpoints in the reference's on-disk format, and the elastic restart."""
from repro_torch.checkpoint.manager import CheckpointManager, save_pytree, restore_pytree  # noqa: F401
from repro_torch.checkpoint.reshard import reshard_to_mesh  # noqa: F401
