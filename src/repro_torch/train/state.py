"""The train state: the model (its float32 parameters are the masters),
the AdamW state over its named parameters, and the step counter."""
from __future__ import annotations

import dataclasses

from repro_torch.models.model import LM
from repro_torch.optim import AdamWState, adamw_init


@dataclasses.dataclass
class TrainState:
    params: LM
    opt: AdamWState
    step: int


def init_train_state(model: LM) -> TrainState:
    """Zero float32 moments beside every parameter of ``model``, step 0."""
    return TrainState(params=model,
                      opt=adamw_init(dict(model.named_parameters())), step=0)
