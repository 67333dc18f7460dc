"""The MoE's dropped assignments in % of its assignments, over every
MoE call the program recorded inside the traced steps: its
``moe.expert_load`` counter holds each call's assignments per expert,
the capacity C and T·k; the dropped ones are, over the call's local
experts, Σ max(0, load − C)."""
from portbench.harness.spans import counters_in


def read(run):
    calls = counters_in(run, "moe.expert_load")
    if not calls:
        return None
    dropped = sum(max(0, n - c.attrs["capacity"]) for c in calls
                  for n in c.value[c.attrs["first"]:
                                   c.attrs["first"] + c.attrs["experts"]])
    return 100.0 * dropped / sum(c.attrs["assignments"] for c in calls)
