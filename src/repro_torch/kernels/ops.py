"""Public wrappers around the kernels (kernel-level dispatch).

``sfa_attention_op`` is the fused SFA forward (rtopk codes -> FlashSFA) on
(batch, seq, heads, head_dim) activations, the counterpart of the JAX
package's ``sfa_attention_op(impl="pallas")`` forward. ``sfa_code`` and
``topk_dense`` route the serving path's other top-k selections through the
rtopk kernel on the card: the prefill cache codes and the decode cache write
(``_sfa_code`` / ``sparsify`` in the JAX package) and the decode query
(``topk_st``). rtopk's contract equals theirs on NaN-free rows — ascending
indices, lowest index wins a tie — so the codes are the same.

Every function here runs the kernels' plain versions on CPU tensors (the
wrappers decide by the tensor's device).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_sfa import flash_sfa
from repro_torch.kernels.rtopk import rtopk


def fold_heads(x):
    """(b, n, h, d) -> (b*h, n, d), h innermost — the kernels' batch layout."""
    b, n, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, n, d)


def unfold_heads(x, b, h):
    """Inverse of ``fold_heads``."""
    bh, n, d = x.shape
    return x.reshape(b, h, n, d).permute(0, 2, 1, 3)


def sfa_code(x, k: int):
    """Top-k code of the rows of x (..., d): (values in x.dtype, int32
    indices ascending), through the rtopk kernel."""
    return rtopk(x, min(k, x.shape[-1]))


def topk_dense(x, k: int):
    """x with all but its k largest-|x| coordinates per row zeroed (the
    forward of ``core.sparse.topk_st``), through the rtopk kernel."""
    vals, idx = sfa_code(x, k)
    return torch.zeros_like(x).scatter_(-1, idx.long(), vals)


def sfa_attention_op(q, k, v, *, sfa_k: int, causal: bool = True,
                     scale: float | None = None):
    """SFA attention forward on (b, n, h, d) q/k/v (heads already
    expanded): fold -> rtopk codes for Q and K -> FlashSFA -> unfold."""
    b, n, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    qv, qi = sfa_code(fold_heads(q), sfa_k)
    kv, ki = sfa_code(fold_heads(k), sfa_k)
    out = flash_sfa(qv, qi, kv, ki, fold_heads(v), d=d, causal=causal,
                    scale=scale)
    return unfold_heads(out, b, h)
