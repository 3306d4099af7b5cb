"""Remat policies of the layer loop: save the compact (n, k) codes, not
dense activations.

Ported from the JAX package's ``repro/core/remat.py``. Three policies
(``ModelConfig.remat``):

  * ``"none"``  — autograd keeps every activation of every layer;
  * ``"full"``  — ``torch.utils.checkpoint`` per layer: only the layer
                  input is kept, and the whole layer (projection -> top-k ->
                  FlashSFA -> MLP) runs again in the backward;
  * ``"codes"`` — ``checkpoint_codes`` per layer: the layer input plus the
                  SFA top-k codes and the per-row LSE are kept (the names of
                  ``CODE_SAVEABLES``), nothing dense besides the input. The
                  backward reruns the layer with those codes: the
                  projection -> top-k pass (``proj_rtopk`` or rtopk) is not
                  run again; the dense V projection, FlashSFA's output and
                  the MLP are.

JAX names the saveables with ``checkpoint_name`` and lets
``jax.checkpoint``'s policy keep them. Here the kernels' autograd Functions
(``kernels/ops.py::_SFAAttention`` and the compact seam of
``models/attention.py``) hand their codes to the active ``CodeStash``: on
the first pass ``checkpoint_codes`` runs the layer without building a graph
and the Functions record their codes; on the backward's rerun the same
Functions take the recorded codes instead of computing them. The codes are
saved as the checkpoint Function's own saved tensors, so a
``torch.autograd.graph.saved_tensors_hooks`` audit sees exactly what the
policy keeps. Indices are kept as int16 (they index head_dim), as in JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.core import reports

REMAT_POLICIES = ("none", "full", "codes")

# What the "codes" policy keeps per SFA layer besides the layer input: the
# compact code tensors and the per-row attention statistics. None of these
# is a dense (n, d) activation.
CODE_SAVEABLES = (
    "sfa_q_code_vals",       # (b·h, n, k)   top-k q values
    "sfa_q_code_idx",        # (b·h, n, k)   their coordinates (int16)
    "sfa_k_code_vals",       # (b·hk, n, k)  top-k k values (hk = hkv on the fused path)
    "sfa_k_code_idx",        # (b·hk, n, k)  their coordinates (int16)
    "sfa_lse",               # (b·h, n)      per-row log-sum-exp
)


def normalize_remat(remat) -> str:
    """A policy name from a ``remat`` value (the deprecated booleans map
    True -> "full", False -> "none")."""
    if remat is True:
        return "full"
    if remat is False or remat is None:
        return "none"
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat={remat!r}; expected one of {REMAT_POLICIES} "
                         f"(or a deprecated bool)")
    return remat


class CodeStash:
    """The codes of one checkpointed layer: recorded on the first pass
    (``put``), handed back in the same order on the backward's rerun
    (``take``)."""

    def __init__(self, saved: Optional[list] = None):
        self.replay = saved is not None
        self._entries: list = list(saved) if saved is not None else []
        self._pos = 0

    def put(self, **named) -> None:
        """Record tensors named from CODE_SAVEABLES, in call order."""
        for name, t in named.items():
            # coordinates index head_dim (< 2**15): kept as int16
            self._entries.append(t.to(torch.int16) if name.endswith("_idx") else t)

    def take(self, *names) -> list:
        got = self._entries[self._pos:self._pos + len(names)]
        if len(got) != len(names):
            raise RuntimeError(f"remat='codes': the rerun asks for {names} but the "
                               f"first pass recorded {len(self._entries)} tensors")
        self._pos += len(names)
        return [t.to(torch.int32) if name.endswith("_idx") else t
                for name, t in zip(names, got)]

    def tensors(self) -> list:
        return self._entries


_ACTIVE: list = []


def active_stash() -> Optional[CodeStash]:
    """The stash of the layer being run under ``checkpoint_codes``, if any."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def _stashing(stash: CodeStash):
    _ACTIVE.append(stash)
    try:
        yield stash
    finally:
        _ACTIVE.pop()


class _CodesCheckpoint(torch.autograd.Function):
    """One layer under remat="codes": forward without a graph, keeping the
    layer input and the recorded codes; backward reruns the layer with the
    codes replayed and differentiates it. The layer returns a tensor or a
    tuple (the output and an aux loss term, None where there is none)."""

    @staticmethod
    def forward(ctx, fn, spec, x, *leaves):
        stash = CodeStash()
        with torch.no_grad(), _stashing(stash):
            y = fn(x, tree_unflatten(list(leaves), spec))
        ctx.fn, ctx.spec = fn, spec
        ctx.leaves = leaves          # parameters: kept by the model anyway
        ctx.save_for_backward(x, *stash.tensors())
        return y

    @staticmethod
    def backward(ctx, *gys):
        x, *codes = ctx.saved_tensors
        xd = x.detach().requires_grad_(ctx.needs_input_grad[2])
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.leaves, ctx.needs_input_grad[3:])]
        with torch.enable_grad(), _stashing(CodeStash(codes)):
            ys = ctx.fn(xd, tree_unflatten(leaves, ctx.spec))
        ys = ys if isinstance(ys, tuple) else (ys,)
        outs = [(y, g) for y, g in zip(ys, gys)
                if y is not None and g is not None and y.requires_grad]
        wanted = [t for t in (xd, *leaves) if t.requires_grad]
        got = iter(torch.autograd.grad([y for y, _ in outs], wanted, [g for _, g in outs],
                                       allow_unused=True))
        grads = [next(got) if t.requires_grad else None for t in (xd, *leaves)]
        return (None, None, *grads)


def checkpoint_codes(fn, x, params):
    """``fn(x, params) -> y`` (or a tuple of y and an aux term) for one layer under
    remat="codes"; ``params`` is the layer's (nested) dict of tensors,
    differentiable inputs."""
    leaves, spec = tree_flatten(params)
    return _CodesCheckpoint.apply(fn, spec, x, *leaves)


# --------------------------------------------------------------------------
# routing reports: what the layer loop applied for a requested policy
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RematReport:
    """One remat routing decision: ``applied`` differs from ``requested``
    when "codes" is asked of a stack whose kernels produce no codes, which
    the loop then runs under "full", saying why."""
    where: str
    requested: str
    applied: str
    reason: Optional[str] = None

    @property
    def eligible(self) -> bool:
        return self.requested == self.applied


_REMAT_REPORTS: dict = {}


def record_remat(where: str, requested: str, applied: str, reason=None) -> None:
    key = (where, requested, applied, reason)
    if key not in _REMAT_REPORTS:
        _REMAT_REPORTS[key] = RematReport(where, requested, applied, reason)


def remat_reports() -> tuple:
    return tuple(_REMAT_REPORTS.values())


def clear_remat_reports() -> None:
    _REMAT_REPORTS.clear()


# the "remat" component of core/reports.py: a read-only view
def _collect_remat_reports():
    return tuple(reports.make_report("remat", r.where, eligible=r.eligible, reason=r.reason,
                                     details={"requested": r.requested, "applied": r.applied})
                 for r in remat_reports())


reports.register_provider("remat", _collect_remat_reports, clear_remat_reports)
