from repro_torch.train.steps import (TrainState, loss_fn,  # noqa: F401
                                     make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
