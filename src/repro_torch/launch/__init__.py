"""Launchers. ``serve``: batched prefill and greedy decode of one
architecture, ``python -m repro_torch.launch.serve``; ``train``: the
training loop (``--mesh DxM`` on a mesh); ``schedule_run``: the VoS
scheduler over real training steps; ``mesh``: device meshes and process
groups; ``specs``: abstract inputs and their shardings; ``dryrun`` and
``hillclimb``: per-device costs of a cell on a fake world,
``python -m repro_torch.launch.dryrun``."""
