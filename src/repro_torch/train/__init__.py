"""Training of the port (counterpart of ``repro/train``): the train step
and the fault-tolerant trainer."""
from .step import init_train_state, make_train_step
from .trainer import Trainer, TrainerConfig

__all__ = ["make_train_step", "init_train_state", "Trainer", "TrainerConfig"]
