"""Training: step factories, checkpointing, fault tolerance and the trainer."""
from repro_torch.train import checkpoint
from repro_torch.train.fault_tolerance import FTConfig, StragglerMonitor, Supervisor
from repro_torch.train.train_step import make_eval_step, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["FTConfig", "StragglerMonitor", "Supervisor", "Trainer", "TrainerConfig",
           "checkpoint", "make_eval_step", "make_train_step"]
