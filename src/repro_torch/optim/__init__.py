"""Optimizers: AdamW and Lion with a warmup + cosine/linear schedule."""
from repro_torch.optim.optimizer import (
    OptimizerConfig, OptState, adamw_update, clip_by_global_norm, global_norm,
    init_opt_state, lion_update, make_optimizer, schedule_lr,
)

__all__ = ["OptState", "OptimizerConfig", "adamw_update",
           "clip_by_global_norm", "global_norm", "init_opt_state",
           "lion_update", "make_optimizer", "schedule_lr"]
