"""Training: step factories and the trainer."""
from repro_torch.train.train_step import make_eval_step, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "make_eval_step", "make_train_step"]
