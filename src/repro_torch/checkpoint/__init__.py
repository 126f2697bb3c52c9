from .checkpoint import (
    CheckpointManager,
    latest_step,
    latest_steps,
    restore_checkpoint,
    save_checkpoint,
)
