from repro_torch.train.state import TrainState, init_train_state
from repro_torch.train.train_step import make_train_step, TrainHParams
from repro_torch.train.serve_step import (greedy_generate, make_decode_step,
                                          make_prefill_step)
