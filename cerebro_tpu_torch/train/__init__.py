"""Training of the PyTorch port (counterpart of cerebro_tpu.train)."""

from cerebro_tpu_torch.train.loss import allpair_loss  # noqa: F401
from cerebro_tpu_torch.train.optim import Adam, AdamState  # noqa: F401
from cerebro_tpu_torch.train.trainer import (  # noqa: F401
    TrainState,
    convert_train_state,
    create_train_state,
    train_step,
)
