"""Training: the grouped optimizer, the train step, and COCO evaluation
(``train/evaluate.py``)."""
from dfvod_tpu_torch.train.engine import (  # noqa: F401
    TrainState,
    create_train_state,
    train_step,
)
