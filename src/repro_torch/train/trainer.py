"""High-level trainer: data, train step and the loop, as in the JAX
package's ``repro/train/trainer.py``.

``Trainer`` runs on the card unless it is given ``device="cpu"``. It keeps
the parameters in f32 and computes in ``cfg.dtype`` (the JAX package's
``param_dtype = "float32"``); its weights are random from ``tcfg.seed``, or
the ``params`` it is given (e.g. ``interop.from_jax`` of a JAX trainer's).
The step runs a plain loop. The fault-tolerance ``Supervisor`` and
checkpointing of the JAX trainer are the ROADMAP item "checkpointing";
gradient compression is the item "distribution".
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ModelConfig, TrainPolicy
from repro_torch.data import DataConfig, copy_batch, markov_batch
from repro_torch.models.model import Model, default_device
from repro_torch.models.model import init as model_init
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    seed: int = 0
    accum_steps: int = 1
    grad_compression: Optional[float] = None
    data_kind: str = "markov"
    # One validated bundle for every execution-policy axis (configs/base.py
    # TrainPolicy). None = run the ModelConfig exactly as configured.
    policy: Optional[TrainPolicy] = None


class Trainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: OptimizerConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig, *, device=None,
                 params: Optional[Model] = None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        device = default_device(device)
        if params is None:
            params = model_init(cfg, device=device, seed=tcfg.seed)
        elif params.device != device:
            raise ValueError(f"params are on {params.device}, the trainer runs "
                             f"on {device}")
        self.params = params.requires_grad_(True)
        self.opt_state = init_opt_state(dict(self.params.named_parameters()))
        self.step_fn = make_train_step(
            cfg, opt_cfg, accum_steps=tcfg.accum_steps,
            grad_compression=tcfg.grad_compression, policy=tcfg.policy)
        self._batch_fn = markov_batch if tcfg.data_kind == "markov" else copy_batch

    def run_step(self, step: int) -> dict:
        batch = self._batch_fn(self.data_cfg, step)
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, batch)
        return {k: float(v) for k, v in metrics.items()}

    def train(self) -> list[dict]:
        history = []
        for step in range(self.tcfg.total_steps):
            m = self.run_step(step)
            if step % self.tcfg.log_every == 0:
                print(f"step {step:5d} loss {m['loss']:.4f} aux {m['aux']:.4g} "
                      f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e}")
            history.append({"step": step, **m})
        return history
