from repro_torch.kernels.moe_dispatch.kernel import (SlotMap, gather_dot,
                                                     gather_rows, gather_sum,
                                                     slot_map)
