from repro_torch.train import step, trainer  # noqa: F401
from repro_torch.train.step import (  # noqa: F401
    TrainHParams,
    TrainState,
    init_state,
    make_train_step,
)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
