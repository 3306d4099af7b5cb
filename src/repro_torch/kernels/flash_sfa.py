"""FlashSFA forward: tiled online-softmax attention over top-k codes.

Replaces the TPU kernel ``repro/kernels/flash_sfa.py::flash_sfa`` with
``block_skip=False`` (Pallas body ``_flash_sfa_kernel``, helpers
``_tile_update``, ``_finalize_tile``, ``_densify_block``) with the CUDA kernel
in ``csrc/flash_sfa.cu``: one block per (bh, 64-query tile), a loop over
64-key tiles up to the causal edge, each key tile densified into shared
memory as (64 × d) f32, scores gathered at each query's own k coordinates
(k multiply-adds per score where the TPU ran a d-wide matmul), online
softmax and P·V in f32.

Bound on the H100: operations (2k flops of score and 2·dv of P·V per
(query, key) pair against O(n·(k + dv)) bytes). The design cuts the score
work from d to k per pair; P·V still runs on CUDA cores, and moving it onto
the tensor cores is work for a later change.

The plain version is ``kernels/ref.py::flash_sfa_ref`` (densify, matmul,
mask, softmax); the wrapper runs it for CPU tensors only. The block-skip
schedule (``block_skip=True`` in the JAX package) is not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_sfa_ref as flash_sfa_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _check(name, t, shape, dtype):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"flash_sfa: {name} is {tuple(t.shape)} {t.dtype}, "
                         f"expected {tuple(shape)} {dtype}")


def flash_sfa(q_vals, q_idx, k_vals, k_idx, v, *, d: int, causal: bool = True,
              scale: float | None = None, return_residuals: bool = False):
    """FlashSFA forward. Codes (bh, n, k) values + indices; v (bh, nk, dv)
    -> out (bh, nq, dv) in v.dtype [, lse (bh, nq) f32].

    Exactly softmax(densify(Q̃)·densify(K̃)ᵀ·scale + causal)·V. On the card
    the code values and v share one dtype (f32 or bf16), indices are int32,
    d <= 256 and dv is 32, 64 or 128.
    """
    scale = float(scale if scale is not None else d ** -0.5)
    _build.refuse_grad("flash_sfa", q_vals, k_vals, v)
    if v.device.type == "cpu":
        return flash_sfa_plain(q_vals, q_idx, k_vals, k_idx, v, d=d,
                               causal=causal, scale=scale,
                               return_residuals=return_residuals)
    if v.device.type != "cuda":
        raise ValueError(f"flash_sfa runs on cuda or cpu tensors, got {v.device}")
    bh, nq, kq = q_vals.shape
    nk, kk = k_vals.shape[1], k_vals.shape[2]
    dv = v.shape[-1]
    dt = v.dtype
    if dt not in _DTYPES or dv not in (32, 64, 128) or not 0 < d <= 256:
        raise ValueError(f"flash_sfa kernel takes f32/bf16 with dv in (32, 64, 128) "
                         f"and d <= 256, got {dt}, dv={dv}, d={d}")
    _check("q_vals", q_vals, (bh, nq, kq), dt)
    _check("q_idx", q_idx, (bh, nq, kq), torch.int32)
    _check("k_vals", k_vals, (bh, nk, kk), dt)
    _check("k_idx", k_idx, (bh, nk, kk), torch.int32)
    _check("v", v, (bh, nk, dv), dt)
    for t in (q_vals, q_idx, k_vals, k_idx):
        if t.device != v.device:
            raise ValueError("flash_sfa: inputs on different devices")
    q_vals, q_idx, k_vals, k_idx, v = (t.contiguous() for t in
                                       (q_vals, q_idx, k_vals, k_idx, v))
    out = torch.empty((bh, nq, dv), dtype=dt, device=v.device)
    lse = (torch.empty((bh, nq), dtype=torch.float32, device=v.device)
           if return_residuals else None)
    fn = _build.entry("flash_sfa", "flash_sfa_fwd_launch", _ARGS)
    with torch.cuda.device(v.device):
        err = fn(q_vals.data_ptr(), q_idx.data_ptr(), k_vals.data_ptr(),
                 k_idx.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if lse is not None else None,
                 bh, nq, nk, kq, kk, d, dv, scale, int(causal), _DTYPES[dt],
                 _build.stream_ptr(v))
    _build.check("flash_sfa", err, "flash_sfa launch")
    flash_sfa.launches += 1
    return (out, lse) if return_residuals else out


flash_sfa.launches = 0
