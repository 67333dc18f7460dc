"""The device time launched under the program's ``ssm`` spans (forward,
recompute and backward) outside its ``repro_torch::ssd_scan*`` ops, in
% of the traced step's device time (``harness.spans.step_share``): the
Mamba-2 mixer's work around the SSD kernels."""
from portbench.harness.spans import step_share


def read(run):
    return step_share(run.ops, ["ssm"], minus_ops="repro_torch::ssd_scan")
