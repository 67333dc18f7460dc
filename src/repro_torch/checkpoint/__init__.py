"""Checkpoint save and restore, failure injection and restart loops,
carried from the JAX package's ``checkpoint/``."""
from repro_torch.checkpoint.ckpt import (save_checkpoint, restore_checkpoint,
                                         latest_step, CheckpointManager)
from repro_torch.checkpoint.failure import (FailureInjector, NodeFailure,
                                            run_with_restarts)
