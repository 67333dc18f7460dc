"""Runtime policies, carried from the JAX package's ``runtime``: the
straggler detector (``straggler.py``). Gradient compression waits for the
port of the LM stack."""
from repro_torch.runtime.straggler import StragglerMonitor, BackupStepPolicy
