"""Device kernels launched inside the benchmark's span around each
decode call, per call, in the trace."""


def read(run):
    if run.timeline is None or not run.timeline.spans.get("portbench.decode"):
        return None
    kernels = [a for a in run.timeline.in_spans("portbench.decode") if a.kernel]
    if not kernels:
        return None
    return len(kernels) / len(run.timeline.spans["portbench.decode"])
