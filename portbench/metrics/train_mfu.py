"""The train step's model FLOP utilisation in %: the configuration's
model FLOPs a step (``harness.readers.train_step_flops``) times the
untraced steps of the window, over their seconds and the bf16 peak."""
from portbench.harness import peaks
from portbench.harness.readers import train_step_flops


def read(run):
    if not run.steps:
        return None
    f = train_step_flops(run.cfg, run.traffic["batch"], run.traffic["seq"])
    return 100.0 * f * len(run.steps) / sum(run.steps) / peaks.BF16_OPS_PER_S
