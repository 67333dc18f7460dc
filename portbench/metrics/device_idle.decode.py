"""The device's idle share in % inside the decode spans alone."""
from portbench.harness.readers import idle_share


def read(run):
    return idle_share(run, "portbench.decode")
