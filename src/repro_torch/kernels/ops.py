"""Public wrappers around the kernels (kernel-level dispatch).

``sfa_attention_op`` is the fused SFA attention on (batch, seq, heads,
head_dim) activations — rtopk codes -> FlashSFA forward, FlashSFA backward —
as one ``torch.autograd.Function``, the counterpart of the JAX package's
``sfa_attention_op(impl="pallas", bwd_emit="dense")`` (its custom_vjp
``_sfa_pallas`` / ``_sfa_fwd`` / ``_sfa_bwd``). The forward saves only the
codes, the folded V, the output and the LSE — not the dense q/k — and the
backward returns the straight-through gradients (paper Eq. 6) in the
inputs' dtypes. ``dense_attention_op`` is the dense baseline's Function over
``flash_attention`` / ``flash_attention_bwd``.

``sfa_code`` and ``topk_dense`` route the serving path's other top-k
selections through the rtopk kernel on the card: the prefill cache codes and
the decode cache write (``_sfa_code`` / ``sparsify`` in the JAX package) and
the decode query (``topk_st``). rtopk's contract equals theirs on NaN-free
rows — ascending indices, lowest index wins a tie — so the codes are the
same.

Every function here runs the kernels' plain versions on CPU tensors (the
wrappers decide by the tensor's device), so the Functions' forward and
backward seam is the same on both devices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_sfa import flash_sfa
from repro_torch.kernels.flash_sfa_bwd import flash_attention_bwd, flash_sfa_bwd
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


class _SFAAttention(torch.autograd.Function):
    """fold -> rtopk codes for Q and K -> FlashSFA (+LSE) -> unfold; the
    backward is FlashSFA's, then unfold."""

    @staticmethod
    def forward(ctx, q, k, v, sfa_k, causal, scale, emit):
        b, n, h, d = q.shape
        qv, qi = sfa_code(fold_heads(q), sfa_k)
        kv, ki = sfa_code(fold_heads(k), sfa_k)
        vf = fold_heads(v).contiguous()
        out, lse = flash_sfa(qv, qi, kv, ki, vf, d=d, causal=causal,
                             scale=scale, return_residuals=True)
        ctx.save_for_backward(qv, qi, kv, ki, vf, out, lse)
        ctx.meta = (b, h, d, causal, scale, emit, q.dtype, k.dtype, v.dtype)
        return unfold_heads(out, b, h)

    @staticmethod
    def backward(ctx, g):
        qv, qi, kv, ki, vf, out, lse = ctx.saved_tensors
        b, h, d, causal, scale, emit, qdt, kdt, vdt = ctx.meta
        dq, dk, dv = flash_sfa_bwd(qv, qi, kv, ki, vf, out, lse,
                                   fold_heads(g.to(vf.dtype)), d=d,
                                   causal=causal, scale=scale, emit=emit)
        return (unfold_heads(dq, b, h).to(qdt), unfold_heads(dk, b, h).to(kdt),
                unfold_heads(dv, b, h).to(vdt), None, None, None, None)


class _DenseAttention(torch.autograd.Function):
    """fold -> FlashAttention (+LSE) -> unfold, and its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        b, _, h, _ = q.shape
        qf, kf, vf = (fold_heads(t).contiguous() for t in (q, k, v))
        out, lse = flash_attention(qf, kf, vf, causal=causal, scale=scale,
                                   return_residuals=True)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.meta = (b, h, causal, scale)
        return unfold_heads(out, b, h)

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, out, lse = ctx.saved_tensors
        b, h, causal, scale = ctx.meta
        grads = flash_attention_bwd(qf, kf, vf, out, lse,
                                    fold_heads(g.to(vf.dtype)), causal=causal,
                                    scale=scale)
        return tuple(unfold_heads(t, b, h) for t in grads) + (None, None)


def sfa_attention_op(q, k, v, *, sfa_k: int, causal: bool = True,
                     scale: float | None = None, bwd_emit: str = "dense"):
    """SFA attention on (b, n, h, d) q/k/v (heads already expanded),
    differentiable through the FlashSFA backward. ``bwd_emit`` is its emit
    layout; only "dense" is ported (the compact ones are ROADMAP A.3 and
    raise in the backward, where the JAX package reads them)."""
    if bwd_emit not in ("dense", "compact", "compact2"):
        raise ValueError(f"bwd_emit={bwd_emit!r}; expected 'dense', "
                         f"'compact' or 'compact2'")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _SFAAttention.apply(q, k, v, sfa_k, causal, scale, bwd_emit)


def dense_attention_op(q, k, v, *, causal: bool = True,
                       scale: float | None = None):
    """Dense attention on (b, n, h, d) q/k/v (heads already expanded),
    differentiable through the dense FlashAttention backward."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _DenseAttention.apply(q, k, v, causal, scale)
