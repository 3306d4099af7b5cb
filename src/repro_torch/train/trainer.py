"""High-level trainer: data, train step, checkpointing and fault tolerance,
as in the JAX package's ``repro/train/trainer.py``.

``Trainer`` runs on the card unless it is given ``device="cpu"``. It keeps
the parameters in f32 and computes in ``cfg.dtype`` (the JAX package's
``param_dtype = "float32"``); its weights are random from ``tcfg.seed``, or
the ``params`` it is given (e.g. ``interop.from_jax`` of a JAX trainer's).
``train`` runs the steps under the ``Supervisor`` (``tcfg.ft``):
checkpoints every ``ckpt_every`` steps and at the last, and on a fault a
restore of the newest one and a replay. ``_save_state`` gives the state in
the JAX Trainer's layout, ``{"params", "opt": OptState(step, m, v)}`` with
the moments nested as the parameters and the step an int32 scalar, and with
``grad_compression`` the residuals as ``"err"``, nested as the parameters
(it sorts before ``"opt"`` in jax.tree_util's order), so a checkpoint
crosses between the two packages. Under a mesh (``axis_rules``) every rank
runs the loop; the Supervisor writes checkpoints from rank 0 only, and
every rank restores.

A Trainer given ``specs`` (``launch.specs.param_specs`` of the parameters
on the active mesh) holds this rank's shard of every parameter, and so of
both moments and the residuals: ``init`` cuts each leaf as it is made, so no
rank holds the whole tree, and given ``params`` it keeps their shards.
``_save_state`` then gathers each leaf whole (every rank must call it), so
rank 0 writes the file a replicated run writes, byte for byte;
``_load_state`` takes whole leaves (a restore) or this rank's shards
(``elastic_remesh``) and keeps this rank's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainPolicy
from repro_torch.data import DataConfig, copy_batch, markov_batch
from repro_torch.distributed.compression import init_error_state
from repro_torch.distributed.shard import gather_full, map_tree, shard_leaf, spec_of
from repro_torch.interop import fill_tree
from repro_torch.models.model import Model, default_device
from repro_torch.models.model import init as model_init
from repro_torch.optim import OptimizerConfig, OptState, init_opt_state
from repro_torch.train.checkpoint import tree_leaves
from repro_torch.train.fault_tolerance import FTConfig, Supervisor
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
    ft: FTConfig = dataclasses.field(default_factory=FTConfig)


class Trainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: OptimizerConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig, *, device=None,
                 params: Optional[Model] = None, specs=None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        device = default_device(device)
        if params is None:
            params = model_init(cfg, device=device, seed=tcfg.seed, specs=specs)
        elif params.device != device:
            raise ValueError(f"params are on {params.device}, the trainer runs "
                             f"on {device}")
        elif specs is not None:
            params.shard(specs)
        self.params = params.requires_grad_(True)
        self.opt_state = init_opt_state(dict(self.params.named_parameters()))
        self.err_state = init_error_state(self.params) if tcfg.grad_compression else None
        self.step_fn = make_train_step(
            cfg, opt_cfg, accum_steps=tcfg.accum_steps,
            grad_compression=tcfg.grad_compression, policy=tcfg.policy)
        self._batch_fn = markov_batch if tcfg.data_kind == "markov" else copy_batch

    # --- FT state plumbing -------------------------------------------------
    def _live_state(self):
        """The live state in the JAX Trainer's layout: the parameters,
        moments and residuals themselves (this rank's shards, if sharded)."""
        params = self.params.tree()
        opt = self.opt_state
        state = {"params": params,
                 "opt": OptState(np.asarray(opt.step, np.int32), fill_tree(params, opt.m),
                                 fill_tree(params, opt.v))}
        if self.err_state is not None:
            state["err"] = fill_tree(params, self.err_state)
        return state

    def _save_state(self):
        """The state in the JAX Trainer's layout, each leaf whole: the live
        tensors (a checkpoint copies them), or where a parameter is sharded
        its leaves gathered (every rank must call this)."""
        state = self._live_state()
        params = state["params"]

        def whole(tree):
            return map_tree(lambda t, p: gather_full(t.detach(), spec_of(p)), tree, params)
        out = {"params": whole(params),
               "opt": state["opt"]._replace(m=whole(state["opt"].m), v=whole(state["opt"].v))}
        if "err" in state:
            out["err"] = whole(state["err"])
        return out

    def _load_state(self, state):
        """Copy ``state`` (as ``_save_state`` lays it out; each leaf whole,
        or already this rank's shard) into the live parameters, moments and
        residuals in place, and set the step."""
        live = self._live_state()
        keys = ("params", "err") if "err" in live else ("params",)
        dst = tree_leaves([*(live[k] for k in keys), live["opt"].m, live["opt"].v])
        src = tree_leaves([*(state[k] for k in keys), state["opt"].m, state["opt"].v])
        specs = [spec_of(p) for p in tree_leaves(live["params"])] * (len(keys) + 2)
        with torch.no_grad():
            for d, s, spec in zip(dst, src, specs, strict=True):
                s = torch.as_tensor(s, device=d.device)
                d.copy_(s if s.shape == d.shape else shard_leaf(s, spec))
        self.opt_state = self.opt_state._replace(step=int(state["opt"].step))

    # --- loop ----------------------------------------------------------------
    def run_step(self, step: int) -> dict:
        batch = self._batch_fn(self.data_cfg, step)
        if self.err_state is not None:
            self.params, self.opt_state, metrics, self.err_state = self.step_fn(
                self.params, self.opt_state, batch, self.err_state)
        else:
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
        return {k: float(v) for k, v in metrics.items()}

    def train(self, fault_injector=None) -> list[dict]:
        """``total_steps`` steps under the Supervisor: its logs, one
        ``{"step", **metrics}`` a step run and one ``{"step", "event":
        "restart", "error"}`` a fault. ``fault_injector(step)`` runs before
        each step (tests raise from it)."""
        sup = Supervisor(self.tcfg.ft, save_state=self._save_state,
                         load_state=self._load_state)

        def step_fn(step):
            if fault_injector is not None:
                fault_injector(step)
            m = self.run_step(step)
            if step % self.tcfg.log_every == 0:
                print(f"step {step:5d} loss {m['loss']:.4f} aux {m['aux']:.4g} "
                      f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e}")
            return m

        return sup.run(step_fn, self.tcfg.total_steps)
