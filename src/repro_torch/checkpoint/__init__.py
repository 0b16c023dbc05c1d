"""repro_torch.checkpoint — atomic, async checkpoints of tensor trees."""
from repro_torch.checkpoint.cluster import (restore_bound_state,
                                            save_bound_state)
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager", "save_bound_state", "restore_bound_state"]
