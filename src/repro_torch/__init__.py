"""PyTorch/CUDA port of the ``repro`` package (JITA-4DS edge pipelines).

The package mirrors ``repro``'s layout module by module and imports
neither ``jax`` nor ``repro``. What is ported so far:

- ``pipeline``: the paper's edge stream services (broker, producers,
  store, services, composition) and the just-in-time edge→VDC offload
  (``queries.HybridExecutor``), with the analytics operators in torch;
- ``kernels.window_agg``: the segment reduction behind the offload, a
  CUDA C++ kernel for Hopper (``kernels/csrc/window_agg.cu``);
- ``convert``: carries the JAX package's parameters (as numpy) across.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see ``device.resolve_device``).
"""
from repro_torch.device import resolve_device
