"""The device time launched under the program's ``train.optimizer``
span (clipping, the schedule, AdamW), in % of the traced step's device
time (``harness.spans.step_share``)."""
from portbench.harness.spans import step_share


def read(run):
    return step_share(run.ops, ["train.optimizer"])
