"""The scenario layer of the port, so far:

  profiles.py   ServiceSLO / ServiceProfile — the single source of
                truth for operator cost
  calibrate.py  KernelCalibrator — measure flops_per_record from dry-runs
                of the port's kernels on the card instead of declaring it
  engine.py     analytics_cost_model / HintedVPTR — the DC-side glue
                that prices calibrated profiles in the JITA-4DS Simulator

The spec, the engine proper, the ledger, observation, screening and
feedback modules of the JAX package's ``scenario`` are not ported yet.
"""
from repro_torch.scenario.profiles import ServiceProfile, ServiceSLO
from repro_torch.scenario.engine import HintedVPTR, analytics_cost_model
from repro_torch.scenario.calibrate import (Calibration, KernelCalibrator,
                                            calibrate_profiles)
