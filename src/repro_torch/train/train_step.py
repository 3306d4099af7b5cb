"""Train and eval step factories, as in the JAX package's
``repro/train/train_step.py``.

``make_train_step(cfg, opt_cfg, ...)`` returns
``step(params, opt_state, batch[, err_state]) -> (params, opt_state,
metrics[, err_state])``: ``loss_fn`` -> ``torch.autograd.grad`` over every
parameter -> [top-k compression with error feedback,
``distributed/compression.py``, whose residual ``err_state`` goes in and
comes back] -> the optimizer update (in place, see ``optim/optimizer.py``). ``accum_steps > 1`` splits the
batch into that many microbatches and averages their gradients, one
microbatch's activations alive at a time (its metrics average the microbatches' ce
and aux; the JAX step reports aux 0 there). The execution-policy axes (remat,
backend, bwd_emit, fwd_fuse, ring, tp) come in as one ``TrainPolicy``
(``policy=``), validated against the model when the step is built.

Under a mesh (``distributed.sharding.axis_rules``) every rank is given the
global batch and takes its ``data`` share; the ranks of a seq / model line
hold the same share (the kernel regions split it). The loss each rank
differentiates is its tokens' summed CE over the global token count (plus
the aux terms over the data degree), and the gradients are summed over
``data`` before the update, so the step is the single-process step on the
global batch (the MoE aux terms and routing groups are per data shard). The
metrics are the global ones on every rank. A parameter held as shards
(``distributed/shard.py``) gets its gradient from its gather's backward
already summed over ``data`` and cut to this rank's shard, so only the
others are summed here; compression gathers a sharded leaf's gradient and
residual, selects on the whole leaf, as one process does, and keeps the
shard.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainPolicy
from repro_torch.distributed import compression
from repro_torch.distributed.shard import spec_of, sums_over_data
from repro_torch.distributed.sharding import current_mesh
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


def data_share(batch: dict, mesh) -> dict:
    """This rank's rows of the global batch: its ``data`` coordinate's
    contiguous share, as the reference's ("batch", ...) rule places it."""
    dp = 1 if mesh is None else mesh.size("data")
    if dp == 1:
        return batch
    r = mesh.index("data")
    out = {}
    for k, v in batch.items():
        if v.shape[0] % dp:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not divide the data "
                             f"degree {dp}")
        rows = v.shape[0] // dp
        out[k] = v[r * rows:(r + 1) * rows]
    return out


def _loss_and_grads(params: Model, batch: dict, cfg: ModelConfig, mesh):
    """(loss, metrics, {name: grad or None}) of this rank's batch share;
    under a data degree > 1 the global ones (module docstring)."""
    named = dict(params.named_parameters())
    dp = 1 if mesh is None else mesh.size("data")
    if dp == 1:
        loss, metrics = loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        return loss, metrics, dict(zip(named, grads))
    # this share's summed CE over the global token count, the aux terms over
    # the degree: the data-summed gradient is the global one
    cnt = (batch["labels"] >= 0).sum().float().reshape(1)
    total = mesh.all_reduce(cnt.clone(), "data")[0]
    loss, metrics = loss_fn(params, batch, cfg)
    part = metrics["ce"] * (cnt[0] / total.clamp(min=1.0))
    grads = torch.autograd.grad(part + metrics["aux"] / dp, list(named.values()),
                                allow_unused=True)
    mesh.all_reduce_many([g for g, p in zip(grads, named.values())
                          if g is not None and not sums_over_data(p, mesh)], "data")
    ce, aux = mesh.all_reduce(torch.stack([part.detach(), metrics["aux"].detach() / dp]),
                              "data")
    return ce + aux, dict(metrics, ce=ce, aux=aux, tokens=total), dict(zip(named, grads))


def loss_and_grads(params: Model, batch: dict, cfg: ModelConfig):
    """The train step's (loss, metrics, {name: grad}) of the global
    ``batch`` under the active mesh (if any), before any compression or
    update: what the step differentiates."""
    mesh = current_mesh()
    batch = data_share(to_batch(batch, params.device, _dtype(cfg)), mesh)
    return _loss_and_grads(params, batch, cfg, mesh)


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                    accum_steps: int = 1,
                    grad_compression: Optional[float] = None,
                    policy: Optional[TrainPolicy] = None):
    cfg = _resolve(cfg, policy)
    update = make_optimizer(opt_cfg)

    def step(params: Model, opt_state, batch, err_state=None):
        named = dict(params.named_parameters())
        mesh = current_mesh()
        batch = data_share(to_batch(batch, params.device, _dtype(cfg)), mesh)
        if accum_steps == 1:
            loss, metrics, grads = _loss_and_grads(params, batch, cfg, mesh)
        else:
            grads = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in named.items()}
            losses, ces, auxes = [], [], []
            micro = {k: v.chunk(accum_steps) for k, v in batch.items()}
            for i in range(accum_steps):
                loss_i, m_i, g_i = _loss_and_grads(
                    params, {k: v[i] for k, v in micro.items()}, cfg, mesh)
                for k, g in g_i.items():
                    if g is not None:
                        grads[k] += g / accum_steps
                losses.append(loss_i.detach())
                ces.append(m_i["ce"].detach())
                auxes.append(m_i["aux"].detach())
            loss = torch.stack(losses).mean()
            metrics = {"ce": torch.stack(ces).mean(), "aux": torch.stack(auxes).mean(),
                       "tokens": torch.zeros((), device=loss.device)}
        if grad_compression is not None:
            grads, err_state = compression.compress_tree(
                grads, err_state, fraction=grad_compression,
                specs={k: spec_of(p) for k, p in named.items()})
        _, opt_state, opt_metrics = update(opt_cfg, grads, opt_state, named)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        out = (params, opt_state, {k: v.detach() if torch.is_tensor(v) else v
                                   for k, v in metrics.items()})
        return out if grad_compression is None else out + (err_state,)

    return step


def make_eval_step(cfg: ModelConfig, *, policy: Optional[TrainPolicy] = None):
    cfg = _resolve(cfg, policy)

    @torch.no_grad()
    def step(params: Model, batch):
        loss, metrics = loss_fn(params, to_batch(batch, params.device, _dtype(cfg)), cfg)
        return dict(metrics, loss=loss)
    return step
