"""Multi-edge-site fleets and workload drift, carried from the JAX
package's ``online``:

  fleet.py       SiteSpec/FleetSpec/Fleet — several heterogeneous
                 gateways, per-site links, one FIFO-contended shared
                 uplink, site→site record routing
  drift.py       deterministic workload drift — diurnal tides, Poisson
                 bursts, site failure/recovery windows

The observation-protocol types (``BridgeInfo``, ``EpochObservation``,
``ServiceInfo``) resolve lazily from their home,
:mod:`repro_torch.scenario.observe`, so importing this package cannot
cycle back through ``repro_torch.scenario``. The epoch controller is not
ported yet.
"""
from repro_torch.online.fleet import (ContendedUplink, EdgeSite, Fleet,
                                      FleetSpec, SiteSpec)
from repro_torch.online.drift import (DriftScenario, DriftingFarm,
                                      DriftingProducer, constant, diurnal,
                                      piecewise_linear, poisson_bursts,
                                      step_bursts)

_OBSERVE_NAMES = ("BridgeInfo", "EpochObservation", "ServiceInfo")

__all__ = ["ContendedUplink", "EdgeSite", "Fleet", "FleetSpec", "SiteSpec",
           "DriftScenario", "DriftingFarm", "DriftingProducer", "constant",
           "diurnal", "piecewise_linear", "poisson_bursts", "step_bursts",
           *_OBSERVE_NAMES]


def __getattr__(name):
    if name in _OBSERVE_NAMES:
        from repro_torch.scenario import observe
        return getattr(observe, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
