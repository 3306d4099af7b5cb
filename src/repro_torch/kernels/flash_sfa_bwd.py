"""FlashSFA backward (dense and compact emits) and the dense FlashAttention
backward.

Replaces the TPU kernels ``repro/kernels/flash_sfa_bwd.py::flash_sfa_bwd``
(every emit: ``"dense"``, ``"compact"``, ``"compact2"``) and
``::flash_attention_bwd`` (both ``_bwd_impl``: Pallas bodies
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``, emits ``_support_mask``,
``_gather_support`` and ``_pair_closure_gather``). Each call launches two
kernels: dQ (one owner per query tile, walking the key tiles up to the
causal edge) and dK/dV (one owner per key tile, walking the query tiles
from the diagonal): no atomics, a deterministic result. Probabilities are
recomputed from the forward's LSE; D_i = Σ(dO_i ∘ O_i) is one torch
reduction outside the kernels, as the JAX package computes it in XLA.

``flash_sfa_bwd`` chooses its body by dtype and shape, as the forward does
(``flash_sfa.tensor_core_body``):

* bf16 with d = dv in {32, 64, 80, 128, 256} and k <= 32 — the tensor-core
  body (``csrc/flash_sfa_tc.cuh`` on ``csrc/attention_tc.cuh``, the dense
  bf16 backward's schedule; 80 and 256 built from ``flash_sfa_tc_wide.cu``,
  80 in tiles of 96 columns, 256 with two warpgroups a block each owning a
  128-column half of dQ, or of dK and dV, and each computing the whole S
  and dP): each Q̃ and K̃ tile is densified from the codes
  (packed into 32-bit words by a pack kernel, the streamed side staged one
  tile ahead by cp.async) into the swizzled shared-memory layout TMA would
  write; S, dP, dV, dK and dQ run as ``wgmma`` with P and dS split into
  bf16 hi + lo. dQ and dK are emitted from the dense f32 accumulator as the
  TPU's ``_unpack`` does: masked to the support (dense), or staged through
  shared memory and gathered at the stored indices (compact, compact2), so
  the compact emit equals the dense one gathered, bit for bit. Bound on
  the H100: operations, on the tensor cores (10·d flops per (query, key)
  pair, 16·d with the split).
* f32, and bf16 shapes outside that set — the CUDA-core body of
  ``csrc/flash_sfa_bwd.cu`` (SPARSE=true): each tile densified as f32 in
  shared memory and dQ/dK accumulated only on each row's k stored
  coordinates (k multiply-adds per pair), the compact emits written
  straight from those k-wide accumulators. Exact in f32; f32 on the tensor
  cores would be TF32, which fails f32's 1e-4 check. Tiles of 64 rows, and
  of 32 at dv 256, where 64 f32 rows of 256 columns do not fit in shared
  memory beside the rest; dv 256 is built for f32 only (bf16 at d = dv 256
  runs the tensor-core body).

The emit decides what is written: dense rows that are zero off the support
(the straight-through gradient of paper Eq. 6), the values at the stored
indices as (n, k) (``"compact"``: 0 where an index falls outside [0, d)),
or those values laid out on the RoPE pair closure as (n, 2k)
(``"compact2"``: even or unrotated first, odd second).
``flash_sfa_bwd.launches`` / ``.compact_launches`` count either body's
launches by emit (one PERF.md row each); ``.cuda_core_launches`` those of
the CUDA-core body alone. The dtype and shape alone choose the body.

``flash_attention_bwd`` chooses its body by dtype. bf16 runs the
tensor-core kernels of ``csrc/flash_attention.cu`` (the same schedule with
TMA-loaded Q and K); f32 runs ``csrc/flash_sfa_bwd.cu``'s ``SPARSE=false``
CUDA-core form, the exact path. A bf16 call never reaches it.

The plain versions are ``kernels/ref.py::flash_sfa_bwd_ref`` and
``::flash_attention_bwd_ref``; the wrappers run them for CPU tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import HEAD_DIMS as _DENSE_DIMS
from repro_torch.kernels.flash_sfa import MAX_D, packed_scratch, tc_library, tensor_core_body
from repro_torch.kernels.ref import flash_attention_bwd_ref as flash_attention_bwd_plain
from repro_torch.kernels.ref import flash_sfa_bwd_ref as flash_sfa_bwd_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_K = 32          # the largest code width either backward body takes (d: as the
                    # forward's, flash_sfa.MAX_D)
# dv of the backward, either body (the CUDA-core body at 256 in f32 only)
V_HEAD_DIMS = (32, 64, 80, 128, 256)

_SFA_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_TC_ARGS = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_float]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_EMITS = {"dense": 0, "compact": 1, "compact2": 2}
# flash_attention_bwd_launch: bf16 in csrc/flash_attention.cu, f32 in
# csrc/flash_sfa_bwd.cu, one signature
_DENSE_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float]
               + [ctypes.c_int] + [ctypes.c_void_p])
_DENSE_LIBS = {torch.bfloat16: "flash_attention", torch.float32: "flash_sfa_bwd"}


def _check(what, name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(f"{what}: {name} is {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}, expected {tuple(shape)} {dtype} on {device}")


def _delta(o, g):
    """D_i = Σ(dO_i ∘ O_i), f32 (bh, n)."""
    return (g.float() * o.float()).sum(-1).contiguous()


def pair_closure_indices(idx, rot_dim: int):
    """(..., k) stored indices -> (..., 2k) RoPE pair-closure indices, the
    layout of ``emit="compact2"``: ``out[..., t]`` is the even member
    2⌊i_t/2⌋ of stored index i_t's rotation pair and ``out[..., k + t]``
    the odd member. Indices at or beyond ``rot_dim`` have no partner and
    pass through unwidened (both slots i_t; the emit gives the second a 0).
    Not deduped: a pair whose two members are both stored appears twice,
    each copy carrying its own share, and every consumer sums duplicates."""
    rotated = idx < rot_dim
    even = torch.where(rotated, torch.div(idx, 2, rounding_mode="floor") * 2, idx)
    odd = torch.where(rotated, even + 1, idx)
    return torch.cat([even, odd], dim=-1)


def flash_sfa_bwd(q_vals, q_idx, k_vals, k_idx, v, o, lse, g, *, d: int,
                  causal: bool = True, scale: float | None = None,
                  emit: str = "dense", rot_dim: int | None = None):
    """FlashSFA backward. Codes (bh, n, k); v/o/g (bh, n, dv); lse (bh, n)
    f32 -> (dq, dk) in the code values' dtypes and dv (bh, n, dv) in
    v.dtype. dq/dk follow ``emit``: "dense" (bh, n, d) rows, zero off each
    row's stored coordinates; "compact" (bh, n, k) values aligned to
    q_idx/k_idx; "compact2" (bh, n, 2k) values on
    ``pair_closure_indices(idx, rot_dim)`` (default rot_dim = d).

    On the card the code values, v, o and g share one dtype (f32 or bf16),
    indices are int32, k <= 32, d <= 256 and dv is in ``V_HEAD_DIMS``. bf16 with
    d = dv in ``flash_sfa.TC_DIMS`` runs the tensor-core body, everything else
    the CUDA-core body (``flash_sfa.tensor_core_body``), which takes dv 256 in
    f32 only.
    """
    if emit not in _EMITS:
        raise ValueError(f"emit={emit!r}; expected 'dense', 'compact' or 'compact2'")
    rot = d if rot_dim is None else int(rot_dim)
    scale = float(scale if scale is not None else d ** -0.5)
    _build.refuse_grad("flash_sfa_bwd", q_vals, k_vals, v, o, g)
    if v.device.type == "cpu":
        return flash_sfa_bwd_plain(q_vals, q_idx, k_vals, k_idx, v, o, lse, g,
                                   d=d, causal=causal, scale=scale, emit=emit,
                                   rot_dim=rot)
    if v.device.type != "cuda":
        raise ValueError(f"flash_sfa_bwd runs on cuda or cpu tensors, got {v.device}")
    bh, nq, kq = q_vals.shape
    nk, kk = k_vals.shape[1], k_vals.shape[2]
    dv, dt, dev = v.shape[-1], v.dtype, v.device
    if (dt not in _DTYPES or dv not in V_HEAD_DIMS or not 0 < d <= MAX_D
            or not 0 < kq <= MAX_K or not 0 < kk <= MAX_K):
        raise ValueError(f"flash_sfa_bwd kernel takes f32/bf16, dv in {V_HEAD_DIMS}, "
                         f"d <= {MAX_D} and k <= {MAX_K}; got {dt}, dv={dv}, d={d}, "
                         f"k={kq}/{kk}")
    on_tc = tensor_core_body(dt, d, dv, kq, kk)
    if not on_tc and dv == 256 and dt != torch.float32:
        raise ValueError(f"flash_sfa_bwd: the CUDA-core body takes dv 256 in f32 only (bf16 "
                         f"on the tensor-core body: d = dv, k <= {MAX_K}); got {dt}, d={d}")
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
    wq, wk = {"dense": (d, d), "compact": (kq, kk), "compact2": (2 * kq, 2 * kk)}[emit]
    dq = torch.empty((bh, nq, wq), dtype=dt, device=dev)
    dk = torch.empty((bh, nk, wk), dtype=dt, device=dev)
    dvo = torch.empty((bh, nk, dv), dtype=dt, device=dev)
    if on_tc:
        v, g = _build.tma_operand(v), _build.tma_operand(g)
        packed = packed_scratch(bh, nq, kq, nk, kk, dev)
        lib = tc_library(d)
        fn = _build.entry(lib, "flash_sfa_tc_bwd_launch", _TC_ARGS)
        with torch.cuda.device(dev):
            err = fn(q_vals.data_ptr(), q_idx.data_ptr(), k_vals.data_ptr(),
                     k_idx.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                     delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvo.data_ptr(),
                     packed.data_ptr(), bh, nq, nk, kq, kk, d, scale, int(causal),
                     _EMITS[emit], rot, _build.stream_ptr(v))
        _build.check(lib, err, "flash_sfa_bwd launch")
    else:
        fn = _build.entry("flash_sfa_bwd", "flash_sfa_bwd_launch", _SFA_ARGS)
        with torch.cuda.device(dev):
            err = fn(q_vals.data_ptr(), q_idx.data_ptr(), k_vals.data_ptr(),
                     k_idx.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                     delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvo.data_ptr(),
                     bh, nq, nk, kq, kk, d, dv, scale, int(causal), _DTYPES[dt],
                     _EMITS[emit], rot, _build.stream_ptr(v))
        _build.check("flash_sfa_bwd", err, "flash_sfa_bwd launch")
        flash_sfa_bwd.cuda_core_launches += 1
    if emit == "dense":
        flash_sfa_bwd.launches += 1
    else:
        flash_sfa_bwd.compact_launches += 1
    return dq, dk, dvo


flash_sfa_bwd.launches = 0            # emit="dense", either body
flash_sfa_bwd.compact_launches = 0    # emit="compact" | "compact2", either body
flash_sfa_bwd.cuda_core_launches = 0  # the CUDA-core body, any emit


def flash_attention_bwd(q, k, v, o, lse, g, *, causal: bool = True,
                        scale: float | None = None):
    """Dense FlashAttention backward. q/k/v/o/g (bh, n, d), lse (bh, n)
    f32 -> dq, dk, dv in q's, k's and v's dtypes. On the card all five share
    one dtype and d = dv is 32, 64 or 128: bf16 runs the tensor-core kernels
    of ``csrc/flash_attention.cu``, f32 the CUDA-core kernels of
    ``csrc/flash_sfa_bwd.cu`` (exact in f32, see the module docstring)."""
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
    if dt not in _DENSE_LIBS or d not in _DENSE_DIMS:
        raise ValueError(f"flash_attention_bwd kernel takes f32/bf16 with d = dv in "
                         f"{_DENSE_DIMS}, got {dt}, d={d}")
    what = "flash_attention_bwd"
    _check(what, "q", q, (bh, nq, d), dt, dev)
    _check(what, "k", k, (bh, nk, d), dt, dev)
    _check(what, "v", v, (bh, nk, d), dt, dev)
    _check(what, "o", o, (bh, nq, d), dt, dev)
    _check(what, "g", g, (bh, nq, d), dt, dev)
    _check(what, "lse", lse, (bh, nq), torch.float32, dev)
    q, k, v, g = (_build.tma_operand(t) for t in (q, k, v, g))
    lse = lse.contiguous()
    delta = _delta(o, g)
    dq, dk, dvo = (torch.empty_like(t) for t in (q, k, v))
    lib = _DENSE_LIBS[dt]
    fn = _build.entry(lib, "flash_attention_bwd_launch", _DENSE_ARGS)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvo.data_ptr(), bh, nq,
                 nk, d, scale, int(causal), _build.stream_ptr(v))
    _build.check(lib, err, "flash_attention_bwd launch")
    flash_attention_bwd.launches += 1
    return dq, dk, dvo


flash_attention_bwd.launches = 0
