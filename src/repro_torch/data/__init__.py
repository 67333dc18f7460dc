from repro_torch.data.tokens import SyntheticLM, make_batch
from repro_torch.data.loader import ShardedLoader
