from rnntransducer_tpu_torch.train.optim import make_optimizer, make_schedule
from rnntransducer_tpu_torch.train.state import (TrainState, eval_step,
                                                 learning_rate_at, loss_fn,
                                                 train_step)

__all__ = ["TrainState", "eval_step", "learning_rate_at", "loss_fn",
           "make_optimizer", "make_schedule", "train_step"]
