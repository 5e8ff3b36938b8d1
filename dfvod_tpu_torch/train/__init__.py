"""Training: the grouped optimizer and the train step."""
from dfvod_tpu_torch.train.engine import (  # noqa: F401
    TrainState,
    create_train_state,
    train_step,
)
