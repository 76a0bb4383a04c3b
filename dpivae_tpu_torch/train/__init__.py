"""Model assembly and training (counterpart of dpivae_tpu/train/)."""

from dpivae_tpu_torch.train.optim import make_optimizer  # noqa: F401
from dpivae_tpu_torch.train.setup import init_params, setup_model  # noqa: F401
from dpivae_tpu_torch.train.train import (  # noqa: F401
    TRAIN_COLUMNS,
    VAL_COLUMNS,
    TrainLogs,
    build_train_fn,
    train_model,
)
