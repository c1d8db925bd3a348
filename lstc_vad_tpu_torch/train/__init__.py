from .optim import clip_gradients, make_optimizer  # noqa: F401
from .state import TrainState, create_train_state  # noqa: F401
from .steps import (  # noqa: F401
    TrainStep,
    make_ltn_train_step,
    make_stn_bce_train_step,
    make_stn_train_step,
    make_train_step,
)
