from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointError, all_steps, latest_step, restore_checkpoint, save_checkpoint)
