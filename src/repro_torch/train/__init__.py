"""QAT training: the train step, the chunked loss, and the fault-tolerant
Trainer that drives checkpoint/elastic/data together.  Counterpart of
``repro/train``."""

from repro_torch.train.loss import xent_loss
from repro_torch.train.train_step import TrainStepConfig, init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["xent_loss", "TrainStepConfig", "make_train_step",
           "init_train_state", "Trainer", "TrainerConfig"]
