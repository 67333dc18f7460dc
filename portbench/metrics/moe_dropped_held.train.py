"""The MoE's dropped assignments in % of the assignments its held
experts received, over every MoE call the program recorded inside the
traced steps: of a call's ``moe.expert_load`` counter (assignments per
routed expert, the capacity C, and the held experts ``first`` ..
``first + experts``), Σ max(0, load − C) ÷ Σ load over the held experts.
Where a layer holds only a share of the experts its router scores, this
is the share's own drop rate, which ``moe_dropped.train`` (over all T·k
assignments) reads at the share's fraction of it."""
from portbench.harness.spans import counters_in


def read(run):
    calls = counters_in(run, "moe.expert_load")
    if not calls:
        return None
    held = [(n, c.attrs["capacity"]) for c in calls
            for n in c.value[c.attrs["first"]:
                             c.attrs["first"] + c.attrs["experts"]]]
    total = sum(n for n, _ in held)
    if not total:
        return None
    return 100.0 * sum(max(0, n - cap) for n, cap in held) / total
