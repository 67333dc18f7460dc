"""PyTorch/CUDA port of the ``repro`` package (JITA-4DS edge pipelines).

The package mirrors ``repro``'s layout module by module and imports
neither ``jax`` nor ``repro``. What is ported so far:

- ``pipeline``: the paper's edge stream services (broker, producers,
  store, services, composition) and the just-in-time edge→VDC offload
  (``queries.HybridExecutor``), with the analytics operators in torch;
- ``kernels``: the three Pallas kernels of the JAX package as CUDA C++
  kernels for Hopper (``kernels/csrc/``): ``window_agg``, the segment
  reduction behind the offload, and ``flash_attention`` and ``ssd_scan``,
  which the calibrator dry-runs and the models run;
- ``core``: the JITA-4DS core of the paper's §4 (VoS curves, the VDC pod
  grid, the heuristics, the discrete-event ``Simulator``) with the cost
  modules it needs (``hardware``, ``configs``, ``roofline``, ``utils``),
  carried as they are;
- ``scenario``: the declarative ``ScenarioSpec`` and the engine it
  compiles into, service profiles, the ``KernelCalibrator`` that measures
  an operator's flops per record from a dry-run on the card, and the
  cost cells that price them in the ``Simulator``;
- ``placement``, ``region``, ``online``, ``chaos``: plans, the placement
  and region searches (with a forked exact-tier pool), and the online and
  chaos controllers, carried as they are;
- ``fluid``: the batched fluid engine, whose time-stepper scores drift
  realizations × plans at once on the card;
- ``serve``: the live serving runtime, carried as it is;
- ``models``, ``data``, ``train``, ``launch``: the language models'
  serving path (prefill and greedy decode), with attention and the
  Mamba-2 scan on the flash and SSD kernels;
- ``sharding``, ``runtime``, ``launch.{mesh,specs,dryrun,hillclimb}``:
  distribution over a ``torch.distributed`` ``DeviceMesh`` with DTensor
  placements (the logical-axis rules, the MoE's expert parallelism, the
  sharded loader, elastic restore, GPipe, compressed all-reduce) and the
  dry-run, which runs a cell under ``FakeTensorMode`` on a fake process
  group of 256 or 512 ranks;
- ``convert``: carries the JAX package's parameters (as numpy) across.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see ``device.resolve_device``).
"""
from repro_torch.device import resolve_device
