"""Unplanned faults for the scenario engine (site crashes, partitions,
link stragglers) and the controller that reacts to them, carried from
the JAX package's ``chaos``."""
from repro_torch.chaos.spec import (ChaosSpec, SiteCrash, Partition,
                                    LinkStraggle)
from repro_torch.chaos.inject import ChaosTimeline, FaultObservation
from repro_torch.chaos.migrate import ChaosMigration, plan_chaos_migrations


def __getattr__(name):
    # ChaosController pulls in the whole online/search stack; lazy so
    # `scenario.spec -> chaos.spec` never re-enters a partially
    # initialized `repro_torch.scenario` through `online.controller`.
    if name == "ChaosController":
        from repro_torch.chaos.controller import ChaosController
        return ChaosController
    raise AttributeError(name)
