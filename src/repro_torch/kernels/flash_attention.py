"""Dense FlashAttention forward: the paper's dense baseline (Dense_* rows).

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(``_flash_fwd``, Pallas body ``_flash_kernel``) with the CUDA kernels in
``csrc/flash_attention.cu``, chosen by dtype:

* bf16 — the tensor-core body: one block of two warpgroups per (bh,
  128-query tile); K/V 64-key tiles arrive by TMA one stage ahead; S = Q·Kᵀ
  and P·V run as ``wgmma`` (bf16 in, f32 accumulate), with the online
  softmax in registers. P is an f32 value, so P·V takes it split in two
  bf16 parts (hi = bf16(p), lo = bf16(p − hi)) accumulated into the same
  f32 registers: ~16 bits of P, where one bf16 rounding would miss the
  1e-4 absolute check on outputs near zero.
* f32 — the CUDA-core body (4 threads per query row, f32 arithmetic): the
  exact path. f32 on the tensor cores would be TF32 (~3 decimal digits),
  which fails f32's 1e-4 check. A bf16 call never reaches it.

Bound on the H100: at the training shape (n 1024, causal) 4d flops per
(query, key) pair against 8d bytes per row is ~256 flops per byte, just
under the card's ~295 for bf16, so the bytes bound it, narrowly; the bf16
body runs the products on the tensor cores (6d flops per pair with the
split) while the next K/V tiles arrive. Both bodies emit the per-row LSE
for the backward.

The plain version is ``kernels/ref.py::flash_attention_ref``; the wrapper
runs it for CPU tensors only. Its gradient is ``kernels/ops.py``'s
``dense_attention_op``, over ``flash_attention_bwd``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

# dtype -> the C entry point of its body
_ENTRIES = {torch.float32: "flash_attention_fwd_launch",
            torch.bfloat16: "flash_attention_tc_fwd_launch"}

HEAD_DIMS = (32, 64, 128)   # d = dv of both bodies and of flash_attention_bwd's

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] + \
    [ctypes.c_int] + [ctypes.c_void_p]


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    return_residuals: bool = False):
    """Dense attention forward. q (bh, nq, d), k/v (bh, nk, d) -> out
    (bh, nq, d) in v.dtype [, lse (bh, nq) f32]. On the card q/k/v share one
    dtype and d = dv is 32, 64 or 128: bf16 runs the tensor-core body, f32
    the CUDA-core body (exact in f32, see the module docstring)."""
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
    if dt not in _ENTRIES or d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes f32/bf16 with d = dv in "
                         f"{HEAD_DIMS}, got {dt}, d={d}")
    for name, t, shape in (("q", q, (bh, nq, d)), ("k", k, (bh, nk, d)),
                           ("v", v, (bh, nk, d))):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != v.device:
            raise ValueError(f"flash_attention: {name} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, expected {shape} {dt} on {v.device}")
    q, k, v = (_build.tma_operand(t) for t in (q, k, v))
    out = torch.empty((bh, nq, d), dtype=dt, device=v.device)
    lse = (torch.empty((bh, nq), dtype=torch.float32, device=v.device)
           if return_residuals else None)
    fn = _build.entry("flash_attention", _ENTRIES[dt], _ARGS)
    with torch.cuda.device(v.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if lse is not None else None, bh, nq, nk, d,
                 scale, int(causal), _build.stream_ptr(v))
    _build.check("flash_attention", err, "flash_attention launch")
    flash_attention.launches += 1
    return (out, lse) if return_residuals else out


flash_attention.launches = 0
