"""FlashSFA backward (dense emit) and the dense FlashAttention backward.

Replaces the TPU kernels ``repro/kernels/flash_sfa_bwd.py::flash_sfa_bwd``
with ``emit="dense"`` and ``::flash_attention_bwd`` (both ``_bwd_impl``:
Pallas bodies ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``) with the CUDA
kernels in ``csrc/flash_sfa_bwd.cu``, one source templated on sparse/dense.
Each call launches two kernels: dQ (one block per 64-query tile, walking the
key tiles up to the causal edge) and dK/dV (one block per 64-key tile,
walking the query tiles from the diagonal). Each output tile has one owner:
no atomics, a deterministic result. Probabilities are recomputed from the
forward's LSE; D_i = Σ(dO_i ∘ O_i) is one torch reduction outside the
kernels, as the JAX package computes it in XLA. In the sparse form each
densified tile lives in shared memory and dQ/dK are accumulated only on each
row's k stored coordinates (k multiply-adds per pair, gathered from the
dense tile), then written as dense rows that are zero elsewhere — the
straight-through gradient of paper Eq. 6.

Bound on the H100: operations (scores and dO·V are recomputed in both
kernels, on CUDA cores in f32). Moving the dv-wide products onto the tensor
cores is work for a later change.

The plain versions are ``kernels/ref.py::flash_sfa_bwd_ref`` and
``::flash_attention_bwd_ref``; the wrappers run them for CPU tensors only.
The compact emits (``"compact"``, ``"compact2"``) belong to the compact
training seam, ROADMAP A.3.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_bwd_ref as flash_attention_bwd_plain
from repro_torch.kernels.ref import flash_sfa_bwd_ref as flash_sfa_bwd_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_K = 32

_SFA_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_DENSE_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float]
               + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _check(what, name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(f"{what}: {name} is {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}, expected {tuple(shape)} {dtype} on {device}")


def _delta(o, g):
    """D_i = Σ(dO_i ∘ O_i), f32 (bh, n)."""
    return (g.float() * o.float()).sum(-1).contiguous()


def flash_sfa_bwd(q_vals, q_idx, k_vals, k_idx, v, o, lse, g, *, d: int,
                  causal: bool = True, scale: float | None = None,
                  emit: str = "dense"):
    """FlashSFA backward. Codes (bh, n, k); v/o/g (bh, n, dv); lse (bh, n)
    f32 -> (dq, dk) (bh, n, d) in the code values' dtypes, zero off each
    row's stored coordinates, and dv (bh, n, dv) in v.dtype.

    On the card the code values, v, o and g share one dtype (f32 or bf16),
    indices are int32, k <= 32, d <= 256 and dv is 32, 64 or 128.
    """
    if emit in ("compact", "compact2"):
        raise NotImplementedError(
            f"flash_sfa_bwd emit={emit!r} belongs to the compact training "
            f"seam, ROADMAP A.3; this port emits dense rows")
    if emit != "dense":
        raise ValueError(f"emit={emit!r}; expected 'dense', 'compact' or 'compact2'")
    scale = float(scale if scale is not None else d ** -0.5)
    _build.refuse_grad("flash_sfa_bwd", q_vals, k_vals, v, o, g)
    if v.device.type == "cpu":
        return flash_sfa_bwd_plain(q_vals, q_idx, k_vals, k_idx, v, o, lse, g,
                                   d=d, causal=causal, scale=scale)
    if v.device.type != "cuda":
        raise ValueError(f"flash_sfa_bwd runs on cuda or cpu tensors, got {v.device}")
    bh, nq, kq = q_vals.shape
    nk, kk = k_vals.shape[1], k_vals.shape[2]
    dv, dt, dev = v.shape[-1], v.dtype, v.device
    if (dt not in _DTYPES or dv not in (32, 64, 128) or not 0 < d <= 256
            or not 0 < kq <= _MAX_K or not 0 < kk <= _MAX_K):
        raise ValueError(f"flash_sfa_bwd kernel takes f32/bf16, dv in (32, 64, 128), "
                         f"d <= 256 and k <= {_MAX_K}; got {dt}, dv={dv}, d={d}, "
                         f"k={kq}/{kk}")
    what = "flash_sfa_bwd"
    _check(what, "q_idx", q_idx, (bh, nq, kq), torch.int32, dev)
    _check(what, "k_vals", k_vals, (bh, nk, kk), dt, dev)
    _check(what, "k_idx", k_idx, (bh, nk, kk), torch.int32, dev)
    _check(what, "q_vals", q_vals, (bh, nq, kq), dt, dev)
    _check(what, "v", v, (bh, nk, dv), dt, dev)
    _check(what, "o", o, (bh, nq, dv), dt, dev)
    _check(what, "g", g, (bh, nq, dv), dt, dev)
    _check(what, "lse", lse, (bh, nq), torch.float32, dev)
    q_vals, q_idx, k_vals, k_idx, v, g, lse = (
        t.contiguous() for t in (q_vals, q_idx, k_vals, k_idx, v, g, lse))
    delta = _delta(o, g)
    dq = torch.empty((bh, nq, d), dtype=dt, device=dev)
    dk = torch.empty((bh, nk, d), dtype=dt, device=dev)
    dvo = torch.empty((bh, nk, dv), dtype=dt, device=dev)
    fn = _build.entry("flash_sfa_bwd", "flash_sfa_bwd_launch", _SFA_ARGS)
    with torch.cuda.device(dev):
        err = fn(q_vals.data_ptr(), q_idx.data_ptr(), k_vals.data_ptr(),
                 k_idx.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvo.data_ptr(),
                 bh, nq, nk, kq, kk, d, dv, scale, int(causal), _DTYPES[dt],
                 _build.stream_ptr(v))
    _build.check("flash_sfa_bwd", err, "flash_sfa_bwd launch")
    flash_sfa_bwd.launches += 1
    return dq, dk, dvo


flash_sfa_bwd.launches = 0


def flash_attention_bwd(q, k, v, o, lse, g, *, causal: bool = True,
                        scale: float | None = None):
    """Dense FlashAttention backward. q/k/v/o/g (bh, n, d), lse (bh, n)
    f32 -> dq, dk, dv in q's, k's and v's dtypes. On the card all five share
    one dtype (f32 or bf16) and d = dv is 32, 64 or 128."""
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    _build.refuse_grad("flash_attention_bwd", q, k, v, o, g)
    if v.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, g, causal=causal,
                                         scale=scale)
    if v.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, got {v.device}")
    bh, nq, d = q.shape
    nk = k.shape[1]
    dt, dev = v.dtype, v.device
    if dt not in _DTYPES or d not in (32, 64, 128):
        raise ValueError(f"flash_attention_bwd kernel takes f32/bf16 with d = dv in "
                         f"(32, 64, 128), got {dt}, d={d}")
    what = "flash_attention_bwd"
    _check(what, "q", q, (bh, nq, d), dt, dev)
    _check(what, "k", k, (bh, nk, d), dt, dev)
    _check(what, "v", v, (bh, nk, d), dt, dev)
    _check(what, "o", o, (bh, nq, d), dt, dev)
    _check(what, "g", g, (bh, nq, d), dt, dev)
    _check(what, "lse", lse, (bh, nq), torch.float32, dev)
    q, k, v, g, lse = (t.contiguous() for t in (q, k, v, g, lse))
    delta = _delta(o, g)
    dq, dk, dvo = (torch.empty_like(t) for t in (q, k, v))
    fn = _build.entry("flash_sfa_bwd", "flash_attention_bwd_launch", _DENSE_ARGS)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dvo.data_ptr(), bh, nq, nk, d, scale, int(causal), _DTYPES[dt],
                 _build.stream_ptr(v))
    _build.check("flash_sfa_bwd", err, "flash_attention_bwd launch")
    flash_attention_bwd.launches += 1
    return dq, dk, dvo


flash_attention_bwd.launches = 0
