from repro_torch.data.tokens import SyntheticLM, make_batch
