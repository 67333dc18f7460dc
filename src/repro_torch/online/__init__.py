"""Online fleet control, carried from the JAX package's ``online``:
multi-edge-site topologies with drift-driven re-placement co-simulated
through the DES loop.

  fleet.py       SiteSpec/FleetSpec/Fleet — several heterogeneous
                 gateways, per-site links, one FIFO-contended shared
                 uplink, site→site record routing
  drift.py       deterministic workload drift — diurnal tides, Poisson
                 bursts, site failure/recovery windows
  controller.py  epoch-based re-placement (reuses placement.search over
                 an analytic forecast), oracle + static baselines,
                 migration hysteresis, per-epoch regret telemetry
  des_bridge.py  DEPRECATED shim — ``FleetCoSimulator`` aliases
                 ``ScenarioEngine`` and importing the shim warns
                 (removal: v0.9, 2026-12-01)

The bridge/controller names resolve lazily so the shim's import of
``repro_torch.scenario`` cannot cycle back through this package's eager
imports. The observation-protocol types (``BridgeInfo``,
``EpochObservation``, ``ServiceInfo``) resolve straight from their home,
:mod:`repro_torch.scenario.observe`, so importing them here stays
warning-free; only the legacy engine aliases route through the shim.
"""
from repro_torch.online.fleet import (ContendedUplink, EdgeSite, Fleet,
                                      FleetSpec, SiteSpec)
from repro_torch.online.drift import (DriftScenario, DriftingFarm,
                                      DriftingProducer, constant, diurnal,
                                      piecewise_linear, poisson_bursts,
                                      step_bursts)

_OBSERVE_NAMES = ("BridgeInfo", "EpochObservation", "ServiceInfo")
_BRIDGE_NAMES = ("FleetCoSimulator", "OnlineConfig", "OnlineResult")
_CONTROLLER_NAMES = ("ForecastModel", "ForecastResult", "OnlineController",
                     "OracleController", "StaticController",
                     "plan_on_average_rates")

__all__ = ["ContendedUplink", "EdgeSite", "Fleet", "FleetSpec", "SiteSpec",
           "DriftScenario", "DriftingFarm", "DriftingProducer", "constant",
           "diurnal", "piecewise_linear", "poisson_bursts", "step_bursts",
           *_OBSERVE_NAMES, *_BRIDGE_NAMES, *_CONTROLLER_NAMES]


def __getattr__(name):
    if name in _OBSERVE_NAMES:
        from repro_torch.scenario import observe
        return getattr(observe, name)
    if name in _BRIDGE_NAMES:
        from repro_torch.online import des_bridge
        return getattr(des_bridge, name)
    if name in _CONTROLLER_NAMES:
        from repro_torch.online import controller
        return getattr(controller, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
