"""The prefill's model FLOP utilisation in %: the configuration's model
FLOPs of each untraced prefill of the window (logits at the last
position only), over the prefills' seconds (each to its first token on
the host) and the bf16 peak."""
from portbench.harness import peaks
from portbench.harness.readers import forward_flops


def read(run):
    if not run.prefills:
        return None
    f = sum(forward_flops(run.cfg, b, s, 1) for b, s, _ in run.prefills)
    return 100.0 * f / sum(t for _, _, t in run.prefills) / peaks.BF16_OPS_PER_S
