from rnntransducer_tpu_torch.train.checkpoint import (CheckpointManager,
                                                      average_checkpoint_params,
                                                      load_config, load_decode_params)
from rnntransducer_tpu_torch.train.loop import Trainer
from rnntransducer_tpu_torch.train.metrics import char_error_rate, word_error_rate
from rnntransducer_tpu_torch.train.optim import make_optimizer, make_schedule
from rnntransducer_tpu_torch.train.state import (TrainState, eval_step,
                                                 learning_rate_at, loss_fn,
                                                 train_step, watch_step)

__all__ = ["CheckpointManager", "TrainState", "Trainer", "average_checkpoint_params",
           "char_error_rate", "eval_step", "learning_rate_at", "load_config",
           "load_decode_params", "loss_fn", "make_optimizer", "make_schedule",
           "train_step", "watch_step", "word_error_rate"]
