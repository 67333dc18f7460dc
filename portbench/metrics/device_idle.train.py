"""The device's idle share in % of a train step: the device's busy time
in a traced step over the median untraced step's host seconds
(``harness.readers.step_idle_share``)."""
from portbench.harness.readers import step_idle_share


def read(run):
    return step_idle_share(run, "portbench.step")
