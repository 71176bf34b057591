from repro_torch.checkpoint.manager import (CheckpointManager,  # noqa: F401
                                            latest_step, load_checkpoint,
                                            save_checkpoint)
