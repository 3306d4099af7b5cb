"""Optimizers written out, as in the JAX package's ``repro/optim/optimizer.py``.

AdamW with decoupled weight decay and global-norm clipping, and Lion. The
moments are f32 whatever the parameters' dtype. Parameters, gradients and
moments are flat ``{name: tensor}`` dicts (``dict(model.named_parameters())``
for a ``Model``), with one entry per leaf of the JAX param tree. Weight decay
applies to every leaf with ``ndim >= 2``, as in JAX: that includes the
stacked per-layer norm scales and biases, (num_layers, d_model).

Where the JAX functions return new arrays, these update the parameters and
the moments in place (under ``torch.no_grad()``), which saves a copy of
each; they return them all the same, so the call reads as in JAX.

A parameter held as this rank's shard (``distributed/shard.py``: it
carries its spec) has shard-shaped gradients and moments. The update is
elementwise and runs on the shards unchanged; the global norm sums each
leaf's squares over the axes that split it, and counts a leaf that no axis
splits once, so it is one process's norm on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.distributed.shard import spec_of, split_axes
from repro_torch.distributed.sharding import current_mesh


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"        # cosine | linear | constant


class OptState(NamedTuple):
    step: int
    m: dict
    v: dict


def schedule_lr(cfg: OptimizerConfig, step: int) -> float:
    """Linear warmup to ``cfg.lr``, then cosine (or linear) decay to
    ``min_lr_ratio · lr`` at ``total_steps``."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    frac = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + math.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def global_norm(tree: dict, specs: dict | None = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32. ``specs`` (name ->
    spec or None): the leaves are this rank's shards on the active mesh;
    each leaf's squares are summed over the axes that split it."""
    mesh = current_mesh()
    groups: dict = {}           # the axes that split a leaf -> its squares' sum
    for k, g in tree.items():
        axes = tuple(sorted({a for _, a in split_axes((specs or {}).get(k), mesh)}))
        groups[axes] = groups.get(axes, 0) + torch.sum(torch.square(g.float()))
    total = 0
    for axes, part in groups.items():
        for axis in axes:
            part = mesh.all_reduce(part.reshape(1), axis)[0]
        total = total + part
    return torch.sqrt(total)


def clip_by_global_norm(tree: dict, max_norm: float, specs: dict | None = None):
    """(tree scaled so its global norm is at most ``max_norm``, the norm
    before scaling)."""
    norm = global_norm(tree, specs)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale for k, g in tree.items()}, norm


def init_opt_state(params: dict) -> OptState:
    def zeros():
        return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
    return OptState(step=0, m=zeros(), v=zeros())


def _is_matrix(p) -> bool:
    return p.ndim >= 2


def _grads(grads: dict, params: dict) -> dict:
    """Every parameter's gradient; a missing (None) one is zero."""
    return {k: grads[k] if grads.get(k) is not None else torch.zeros_like(p)
            for k, p in params.items()}


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads: dict, state: OptState, params: dict):
    """One AdamW step -> (params, state, {"lr", "grad_norm"})."""
    grads, gnorm = clip_by_global_norm(_grads(grads, params), cfg.grad_clip,
                                       {k: spec_of(p) for k, p in params.items()})
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    for k, p in params.items():
        g = grads[k].float()
        m = state.m[k].mul_(b1).add_((1 - b1) * g)
        v = state.v[k].mul_(b2).add_((1 - b2) * torch.square(g))
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if _is_matrix(p):            # decoupled decay on matrices only
            u = u + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    return params, OptState(step, state.m, state.v), {"lr": lr, "grad_norm": gnorm}


@torch.no_grad()
def lion_update(cfg: OptimizerConfig, grads: dict, state: OptState, params: dict):
    """One Lion step -> (params, state, {"lr", "grad_norm"})."""
    grads, gnorm = clip_by_global_norm(_grads(grads, params), cfg.grad_clip,
                                       {k: spec_of(p) for k, p in params.items()})
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    for k, p in params.items():
        g = grads[k].float()
        m = state.m[k]
        u = torch.sign(b1 * m + (1 - b1) * g)
        if _is_matrix(p):
            u = u + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
        m.mul_(b2).add_((1 - b2) * g)
    return params, OptState(step, state.m, state.v), {"lr": lr, "grad_norm": gnorm}


def make_optimizer(cfg: OptimizerConfig) -> Callable:
    return {"adamw": adamw_update, "lion": lion_update}[cfg.name]
