"""The device time launched under the program's ``moe.shared`` spans
(the shared expert; forward, recompute and backward), in % of the traced
step's device time (``harness.spans.step_share``)."""
from portbench.harness.spans import step_share


def read(run):
    return step_share(run.ops, ["moe.shared"])
