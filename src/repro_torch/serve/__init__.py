"""Live serving runtime: one spec, DES for planning, this for serving.

``repro_torch.serve`` executes a compiled
:class:`~repro_torch.scenario.spec.ScenarioSpec` on *actual records* — real
:class:`~repro_torch.pipeline.composition.Pipeline` operators driven by real
producers on a deterministic virtual-time asyncio loop — while honoring
the same placement physics the DES simulates. Engine and runtime are
interchangeable observation sources
(:mod:`repro_torch.scenario.observe`): the same controllers re-place live,
the same calibration loop trains, except on *measured* residuals.

  clock.py    VirtualClock — deterministic virtual-time event loop
              driver (seeded runs replay identical interleavings)
  stage.py    FarmDriver / ServiceStage — the serving actors: serial
              operator instances with bounded-queue backpressure
  router.py   PlacementRouter / DCPool — plan schedule, migration
              stalls, analytic DC execution under a finite chip pool
  shaper.py   UplinkShaper — cross-site bytes through the same Fleet /
              ContendedUplink models the DES prices
  metrics.py  ServeTelemetry — measured EpochObservation-compatible
              rates and realized residuals, frozen per epoch
  runtime.py  ServeRuntime / serve_scenario — the engine's live twin

See README §Live serving and ``benchmarks/bench_serve.py`` for the
engine-vs-runtime sim-to-real gap this subsystem makes measurable.
"""
from repro_torch.serve.clock import VirtualClock
from repro_torch.serve.metrics import ServeTelemetry, StageFire
from repro_torch.serve.router import DCPool, PlacementRouter
from repro_torch.serve.runtime import ServeConfig, ServeRuntime, serve_scenario
from repro_torch.serve.shaper import UplinkShaper
from repro_torch.serve.stage import FarmDriver, ServiceStage
