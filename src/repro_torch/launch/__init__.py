"""Launchers. ``serve``: batched prefill and greedy decode of one
architecture, ``python -m repro_torch.launch.serve``."""
