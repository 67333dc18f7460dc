from repro_torch.train.serve_step import (greedy_generate, make_decode_step,
                                          make_prefill_step)
