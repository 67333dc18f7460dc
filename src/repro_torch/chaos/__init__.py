"""Unplanned faults for the scenario engine (site crashes, partitions,
link stragglers), carried from the JAX package's ``chaos``. The chaos
controller is not ported yet."""
from repro_torch.chaos.spec import (ChaosSpec, SiteCrash, Partition,
                                    LinkStraggle)
from repro_torch.chaos.inject import ChaosTimeline, FaultObservation
from repro_torch.chaos.migrate import ChaosMigration, plan_chaos_migrations
