from repro_torch.kernels.window_agg.ops import window_aggregate
from repro_torch.kernels.window_agg.ref import window_aggregate_reference
