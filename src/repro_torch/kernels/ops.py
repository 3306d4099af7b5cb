"""Public wrappers around the kernels (kernel-level dispatch).

``sfa_attention_op`` is the fused SFA attention on (batch, seq, heads,
head_dim) activations — rtopk codes -> FlashSFA forward, FlashSFA backward —
as one ``torch.autograd.Function``, the counterpart of the JAX package's
``sfa_attention_op(impl="pallas")`` (its custom_vjp ``_sfa_pallas`` /
``_sfa_fwd`` / ``_sfa_bwd``). The forward saves only the codes, the folded
V, the output and the LSE — not the dense q/k — and the backward returns
the straight-through gradients (paper Eq. 6) in the inputs' dtypes.
``bwd_emit`` is the backward kernel's dQ/dK emit: "dense" (n, d) rows, or
"compact" (n, k) / "compact2" (n, 2k, on the RoPE pair closure) codes that
one ``scatter_code_grads`` turns into the dense cotangents the op owes (at
the op level RoPE sits outside, so the widening is a lossless relayout).
The training path that never scatters is the fused projection seam of
``models/attention.py``, fed by ``fused_qk_codes``. Under remat="codes"
the Function records its codes in the active ``core.remat.CodeStash`` and
takes them back on the backward's rerun instead of running rtopk again.
``dense_attention_op`` is the dense baseline's Function over
``flash_attention`` / ``flash_attention_bwd``.

``sfa_code`` and ``topk_dense`` route the serving path's other top-k
selections through the rtopk kernel on the card: the prefill cache codes and
the decode cache write (``_sfa_code`` / ``sparsify`` in the JAX package) and
the decode query (``topk_st``). rtopk's contract equals theirs on NaN-free
rows — ascending indices, lowest index wins a tie — so the codes are the
same.

Every function here runs the kernels' plain versions on CPU tensors (the
wrappers decide by the tensor's device), so the Functions' forward and
backward seam is the same on both devices. Under a mesh with a ``model``
axis the kernels run as tensor-parallel regions
(``distributed/shard.py``): rtopk and FlashSFA on this rank's slice of the
folded (b·h) axis, proj_rtopk on its slice of the heads, the outputs
gathered over the axis; outside one they are the plain calls.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.remat import active_stash
from repro_torch.distributed.shard import run_tp, tp_flash_sfa, tp_flash_sfa_bwd
from repro_torch.kernels.code_grad import scatter_code_grads
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_sfa_bwd import flash_attention_bwd, pair_closure_indices
from repro_torch.kernels.rtopk import proj_rtopk, rtopk


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


def tp_sfa_code(x, k: int):
    """``sfa_code`` of folded (b·h, n, d) rows with the (b·h) axis split
    over the model axis (rtopk is row-wise)."""
    return run_tp(lambda t: sfa_code(t, k), (x,), (0,), (0, 0))


def topk_dense(x, k: int):
    """x with all but its k largest-|x| coordinates per row zeroed (the
    forward of ``core.sparse.topk_st``), through the rtopk kernel."""
    vals, idx = sfa_code(x, k)
    return torch.zeros_like(x).scatter_(-1, idx.long(), vals)


def head_blocks(w, start: int, heads: int, hd: int):
    """Columns [start·hd, (start + heads)·hd) of a packed (m, ·) projection
    as (heads, m, hd) per-head blocks: a strided view, no copy."""
    m = w.shape[0]
    return w[:, start * hd:(start + heads) * hd].reshape(m, heads, hd).permute(1, 0, 2)


def repeat_heads(t, b: int, h: int):
    """(b·hk, n, k) folded codes -> (b·h, n, k), each of the hk heads
    repeated h // hk times (the GQA group), b-major as ``fold_heads``."""
    hk = t.shape[0] // b
    if hk == h:
        return t
    return t.reshape(b, hk, *t.shape[1:]).repeat_interleave(h // hk, dim=1).reshape(
        b * h, *t.shape[1:])


def fused_qk_codes(x, w, positions, *, h, hkv, hd, sfa_k, rope_spec=None):
    """q and k codes straight from the activations: x (b, n, m), w the
    packed (m, (h + 2·hkv)·hd) qkv projection. Each head's projection tile
    is built, RoPE'd and top-k'd inside ``proj_rtopk``; no dense q/k is
    written. Returns (q_vals, q_idx) (b·h, n, sfa_k) and (k_vals, k_idx)
    (b·hkv, n, sfa_k), folded b-major / h-inner; the key codes stay at hkv
    heads (``repeat_heads`` expands them, so group members carry identical
    indices, as the unfused repeat-KV -> rtopk composition gives)."""
    b, n, _ = x.shape
    # distributed/shard.py::tp_proj_rtopk's region (w's heads and the codes'
    # axis 1 split over the model axis) around this module's proj_rtopk
    proj = functools.partial(proj_rtopk, k=sfa_k, rope_spec=rope_spec)
    qv, qi = run_tp(proj, (x, head_blocks(w, 0, h, hd), positions), (None, 0, None), (1, 1))
    kv, ki = run_tp(proj, (x, head_blocks(w, h, hkv, hd), positions), (None, 0, None), (1, 1))
    return (qv.reshape(b * h, n, sfa_k), qi.reshape(b * h, n, sfa_k),
            kv.reshape(b * hkv, n, sfa_k), ki.reshape(b * hkv, n, sfa_k))


class _SFAAttention(torch.autograd.Function):
    """fold -> rtopk codes for Q and K -> FlashSFA (+LSE) -> unfold; the
    backward is FlashSFA's, then unfold."""

    @staticmethod
    def forward(ctx, q, k, v, sfa_k, causal, scale, emit):
        b, n, h, d = q.shape
        stash = active_stash()
        vf = fold_heads(v).contiguous()
        if stash is not None and stash.replay:
            qv, qi, kv, ki = stash.take("sfa_q_code_vals", "sfa_q_code_idx",
                                        "sfa_k_code_vals", "sfa_k_code_idx")
            out = tp_flash_sfa(qv, qi, kv, ki, vf, d=d, causal=causal, scale=scale)
            lse, = stash.take("sfa_lse")
        else:
            qv, qi = tp_sfa_code(fold_heads(q), sfa_k)
            kv, ki = tp_sfa_code(fold_heads(k), sfa_k)
            out, lse = tp_flash_sfa(qv, qi, kv, ki, vf, d=d, causal=causal,
                                    scale=scale, return_residuals=True)
            if stash is not None:
                stash.put(sfa_q_code_vals=qv, sfa_q_code_idx=qi,
                          sfa_k_code_vals=kv, sfa_k_code_idx=ki, sfa_lse=lse)
        ctx.save_for_backward(qv, qi, kv, ki, vf, out, lse)
        ctx.meta = (b, h, d, causal, scale, emit, q.dtype, k.dtype, v.dtype)
        return unfold_heads(out, b, h)

    @staticmethod
    def backward(ctx, g):
        qv, qi, kv, ki, vf, out, lse = ctx.saved_tensors
        b, h, d, causal, scale, emit, qdt, kdt, vdt = ctx.meta
        dq, dk, dv = tp_flash_sfa_bwd(qv, qi, kv, ki, vf, out, lse,
                                      fold_heads(g.to(vf.dtype)), d=d,
                                      causal=causal, scale=scale, emit=emit)
        if emit != "dense":
            # the kernel wrote codes; the op owes dense cotangents
            if emit == "compact2":
                qi, ki = pair_closure_indices(qi, d), pair_closure_indices(ki, d)
            dq, dk = scatter_code_grads(dq, qi, d), scatter_code_grads(dk, ki, d)
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
    differentiable through the FlashSFA backward; ``bwd_emit`` is its dQ/dK
    emit layout (see the module docstring)."""
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
