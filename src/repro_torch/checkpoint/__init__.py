"""Failure injection and restart loops, carried from the JAX package's
``checkpoint/failure.py``. Checkpoint save and restore are not ported
yet."""
from repro_torch.checkpoint.failure import (FailureInjector, NodeFailure,
                                            run_with_restarts)
