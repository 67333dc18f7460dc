"""The share, in %, of the run's decode-step calls that ran by a replay
of the step's CUDA graph: the program's tallies ``serve.graph.replay``
over it and ``serve.graph.eager`` (a call that captured the graph
replayed it too). The tallies count whether tracing is on or off, so
they cover the untraced requests and the warm-up's decode steps; a
program without them gives None."""
from portbench.harness.spans import program_record


def read(run):
    tallies = getattr(program_record(), "tallies", None)
    if tallies is None:
        return None
    t = tallies()
    replay, eager = t.get("serve.graph.replay", 0), t.get("serve.graph.eager", 0)
    if replay + eager == 0:
        return None
    return 100.0 * replay / (replay + eager)
