"""The share, in %, of the timeline part's decode spans during which
the host's thread that ran the program's ``serve.decode`` was inside
its ``moe`` spans, from the program's in-memory record on the harness's
clock (``harness.spans.host_share``)."""
from portbench.harness.spans import host_share


def read(run):
    return host_share(run, "moe", "portbench.decode", "serve.decode")
