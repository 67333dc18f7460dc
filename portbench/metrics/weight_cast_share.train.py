"""The device time launched under the program's ``weight_cast`` spans
(a parameter cast to the compute type at use, forward, recompute and
backward), in % of the traced step's device time
(``harness.spans.step_share``)."""
from portbench.harness.spans import step_share


def read(run):
    return step_share(run.ops, ["weight_cast"])
