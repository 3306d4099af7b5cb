"""Train and eval step factories, as in the JAX package's
``repro/train/train_step.py``.

``make_train_step(cfg, opt_cfg, ...)`` returns
``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
``loss_fn`` -> ``torch.autograd.grad`` over every parameter -> the optimizer
update (in place, see ``optim/optimizer.py``). ``accum_steps > 1`` splits the
batch into that many microbatches and averages their gradients, one
microbatch's activations alive at a time (its metrics average the microbatches' ce
and aux; the JAX step reports aux 0 there). The execution-policy axes (remat,
backend, bwd_emit, fwd_fuse, ring, tp) come in as one ``TrainPolicy``
(``policy=``), validated against the model when the step is built. Top-k
gradient compression is distribution work (ROADMAP, "distribution").
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainPolicy
from repro_torch.models.model import Model, _dtype, loss_fn
from repro_torch.optim import OptimizerConfig, make_optimizer


def _resolve(cfg: ModelConfig, policy: Optional[TrainPolicy]) -> ModelConfig:
    return policy.apply(cfg) if policy is not None else cfg


def to_batch(batch: dict, device, dtype=torch.float32) -> dict:
    """numpy/torch batch -> tensors on ``device``: integer entries
    ("tokens", "labels") as int64, float features (a vlm's "patches", an
    audio model's "frames") in ``dtype``."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        out[k] = t.to(dtype) if t.is_floating_point() else t.long()
    return out


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                    accum_steps: int = 1,
                    grad_compression: Optional[float] = None,
                    policy: Optional[TrainPolicy] = None):
    if grad_compression is not None:
        raise NotImplementedError("top-k gradient compression is distribution "
                                  "work (ROADMAP, \"distribution\")")
    cfg = _resolve(cfg, policy)
    update = make_optimizer(opt_cfg)

    def compute_grads(names, leaves, params, batch):
        loss, metrics = loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss, metrics, dict(zip(names, grads))

    def step(params: Model, opt_state, batch):
        named = dict(params.named_parameters())
        names, leaves = list(named), list(named.values())
        batch = to_batch(batch, params.device, _dtype(cfg))
        if accum_steps == 1:
            loss, metrics, grads = compute_grads(names, leaves, params, batch)
        else:
            grads = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in named.items()}
            losses, ces, auxes = [], [], []
            micro = {k: v.chunk(accum_steps) for k, v in batch.items()}
            for i in range(accum_steps):
                loss_i, m_i, g_i = compute_grads(
                    names, leaves, params, {k: v[i] for k, v in micro.items()})
                for k, g in g_i.items():
                    if g is not None:
                        grads[k] += g / accum_steps
                losses.append(loss_i.detach())
                ces.append(m_i["ce"].detach())
                auxes.append(m_i["aux"].detach())
            loss = torch.stack(losses).mean()
            metrics = {"ce": torch.stack(ces).mean(), "aux": torch.stack(auxes).mean(),
                       "tokens": torch.zeros((), device=loss.device)}
        _, opt_state, opt_metrics = update(opt_cfg, grads, opt_state, named)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, {k: v.detach() if torch.is_tensor(v) else v
                                   for k, v in metrics.items()}

    return step


def make_eval_step(cfg: ModelConfig, *, policy: Optional[TrainPolicy] = None):
    cfg = _resolve(cfg, policy)

    @torch.no_grad()
    def step(params: Model, batch):
        loss, metrics = loss_fn(params, to_batch(batch, params.device, _dtype(cfg)), cfg)
        return dict(metrics, loss=loss)
    return step
