"""The share of its roofline, in %, of every call of the op
``repro_torch::ssd_scan_backward`` in the trace (``harness.readers.op_roofline``)."""
from portbench.harness.readers import op_roofline


def read(run):
    return op_roofline(run, "repro_torch::ssd_scan_backward")
