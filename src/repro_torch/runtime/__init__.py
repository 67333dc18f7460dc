"""Runtime policies, carried from the JAX package's ``runtime``: the
straggler detector (``straggler.py``), gradient compression with error
feedback around an all-reduce (``compression.py``) and the GPipe pipeline
over a mesh axis (``pp.py``)."""
from repro_torch.runtime.straggler import StragglerMonitor, BackupStepPolicy
