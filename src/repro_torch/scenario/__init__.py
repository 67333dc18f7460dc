"""Unified Scenario API of the port: one declarative spec → one
DES-bridged engine, carried from the JAX package's ``scenario``.

  spec.py       ScenarioSpec / scenario() builder — pipeline DAG,
                per-service profiles, fleet topology, drift schedule,
                SLO/value specs; JSON round-trip; ``compile()``
  engine.py     ScenarioEngine — the one co-simulation engine: every
                DC-placed fire submits incrementally into one
                persistent JITA-4DS Simulator (event-feed DES bridge);
                ``run_plan`` for static placements, ``run(controller)``
                for epoch-based re-placement
  screen.py     ScreeningModel — tier-1 vectorized batch plan scorer
                over the placement-independent fire trace
  queueing.py   the queueing-inflation knee every ranking tier shares
                (scalar, numpy and torch variants)
  profiles.py   ServiceSLO / ServiceProfile — the single source of
                truth for operator cost
  calibrate.py  KernelCalibrator — measure flops_per_record from
                dry-runs of the port's kernels (window_agg,
                flash_attention, ssd_scan); on the card they launch the
                CUDA kernels, so ``spec.compile(calibrator=
                KernelCalibrator())`` runs them during the compile
  observe.py    shared observation protocol — BridgeInfo /
                EpochObservation / ObservationSource
  feedback.py   CalibrationLoop — closed-loop forecast calibration:
                RLS-fitted per-service correction terms from realized
                engine residuals
  ledger.py     exact record-conservation accounting shared by all runs

Everything but ``calibrate`` and ``queueing.q_factor_torch`` is host code
(stdlib and numpy), carried with the reference's arithmetic in its order.
"""
from repro_torch.scenario.profiles import ServiceProfile, ServiceSLO
from repro_torch.scenario.ledger import RecordLedger, ServiceLedger, FireRec
from repro_torch.scenario.observe import (BridgeInfo, EpochObservation,
                                          ObservationSource, ServiceInfo,
                                          epoch_bounds, epoch_of)
from repro_torch.scenario.engine import (CoSimResult, EngineConfig,
                                         EngineResult, HintedVPTR,
                                         ScenarioEngine,
                                         analytics_cost_model,
                                         single_site_fleet)
from repro_torch.scenario.spec import (FarmSpec, RateSpec, ScenarioBuilder,
                                       ScenarioSpec, ServiceSpec, StoreSpec,
                                       scenario)
from repro_torch.scenario.calibrate import (Calibration, KernelCalibrator,
                                            calibrate_profiles)
from repro_torch.scenario.feedback import (CalibrationLoop,
                                           ServiceCalibration,
                                           ServiceCorrection)
from repro_torch.scenario.screen import ScreeningModel, ScreenResult
