from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                   bias_corrections)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup
from repro_torch.optim.clipping import global_norm, clip_by_global_norm
