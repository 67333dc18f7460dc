"""DEPRECATED location — the fleet co-simulator *is* the unified
scenario engine now (``repro_torch.scenario.engine``).

The incremental event-feed DES bridge that debuted here (one persistent
JITA-4DS Simulator, ``inject``-as-produced, migration stalls via the
elastic cost model, per-service and per-site conservation ledgers) was
generalized to cover the single-site case as well and moved to
:mod:`repro_torch.scenario.engine`; this module keeps the historical
names importable:

  ``FleetCoSimulator``  → :class:`repro_torch.scenario.engine.ScenarioEngine`
  ``OnlineConfig``      → :class:`repro_torch.scenario.engine.EngineConfig`
  ``OnlineResult``      → :class:`repro_torch.scenario.engine.EngineResult`

The observation-protocol types (``BridgeInfo``, ``EpochObservation``,
``ServiceInfo``) are *not* deprecated — they moved to
:mod:`repro_torch.scenario.observe` and stay importable from
``repro_torch.online`` without touching this shim.

New code should build engines from a declarative
:class:`~repro_torch.scenario.spec.ScenarioSpec` via ``spec.compile()``.
Importing this module emits a :class:`DeprecationWarning`; it will be
removed in v0.9 (2026-12-01) — see README, Migration table.
"""
import warnings

from repro_torch.scenario.engine import (EngineConfig, EngineResult,  # noqa: F401
                                         ScenarioEngine)
from repro_torch.scenario.observe import (BridgeInfo, EpochObservation,  # noqa: F401
                                          ServiceInfo)

warnings.warn(
    "repro_torch.online.des_bridge is deprecated and will be removed in v0.9 "
    "(2026-12-01): FleetCoSimulator/OnlineConfig/OnlineResult are "
    "repro_torch.scenario's ScenarioEngine/EngineConfig/EngineResult; the "
    "observation types live in repro_torch.scenario.observe (see README, "
    "Migration table)", DeprecationWarning, stacklevel=2)

FleetCoSimulator = ScenarioEngine
OnlineConfig = EngineConfig
OnlineResult = EngineResult
