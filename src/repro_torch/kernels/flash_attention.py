"""Dense FlashAttention forward: the paper's dense baseline (Dense_* rows).

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(``_flash_fwd``, Pallas body ``_flash_kernel``) with the CUDA kernel in
``csrc/flash_attention.cu``: one block per (bh, 64-query tile), a loop over
64-key tiles up to the causal edge with Q/K/V tiles in shared memory, 4
threads per query row each scoring a quarter of the keys, online softmax and
P·V in f32, and the per-row LSE out for the backward.

Bound on the H100: operations (2d flops of score and 2dv of P·V per
(query, key) pair against O(n·(d + dv)) bytes). Both products run on CUDA
cores in f32; the tensor cores are work for a later change.

The plain version is ``kernels/ref.py::flash_attention_ref``; the wrapper
runs it for CPU tensors only. Its gradient is ``kernels/ops.py``'s
``dense_attention_op``, over ``flash_attention_bwd``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] + \
    [ctypes.c_int] * 2 + [ctypes.c_void_p]


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    return_residuals: bool = False):
    """Dense attention forward. q (bh, nq, d), k/v (bh, nk, d) -> out
    (bh, nq, d) in v.dtype [, lse (bh, nq) f32]. On the card q/k/v share one
    dtype (f32 or bf16) and d = dv is 32, 64 or 128."""
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    _build.refuse_grad("flash_attention", q, k, v)
    if v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     return_residuals=return_residuals)
    if v.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {v.device}")
    bh, nq, d = q.shape
    nk = k.shape[1]
    dt = v.dtype
    if dt not in _DTYPES or d not in (32, 64, 128):
        raise ValueError(f"flash_attention kernel takes f32/bf16 with d = dv in "
                         f"(32, 64, 128), got {dt}, d={d}")
    for name, t, shape in (("q", q, (bh, nq, d)), ("k", k, (bh, nk, d)),
                           ("v", v, (bh, nk, d))):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != v.device:
            raise ValueError(f"flash_attention: {name} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, expected {shape} {dt} on {v.device}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty((bh, nq, d), dtype=dt, device=v.device)
    lse = (torch.empty((bh, nq), dtype=torch.float32, device=v.device)
           if return_residuals else None)
    fn = _build.entry("flash_attention", "flash_attention_fwd_launch", _ARGS)
    with torch.cuda.device(v.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if lse is not None else None, bh, nq, nk, d,
                 scale, int(causal), _DTYPES[dt], _build.stream_ptr(v))
    _build.check("flash_attention", err, "flash_attention launch")
    flash_attention.launches += 1
    return (out, lse) if return_residuals else out


flash_attention.launches = 0
