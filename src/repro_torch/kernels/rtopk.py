"""rtopk: row-wise exact top-|k| by bisection on IEEE-754 bit patterns.

Replaces the TPU kernel ``repro/kernels/rtopk.py::rtopk`` (Pallas body
``_rtopk_kernel`` -> ``_topk_select``) with the CUDA kernel in
``csrc/rtopk.cu``: one warp per row, the row strided across lanes, the
exact 32-step bisection counted with ``__ballot_sync``/``__popc``, ties kept
in ascending index order, values moved bit-exact, NaN read as +0.

Bound on the H100: bytes (the row is read once, k values and k int32
indices are written; the bisection runs on registers). The design keeps the
whole row in one warp's registers so each of the 32 steps is a few ballots
with no shared memory or shuffles.

The plain version is ``kernels/ref.py::rtopk_ref`` (the same bisection in
torch ops); the wrapper runs it for a CPU tensor only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rtopk_ref as rtopk_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def rtopk(x: torch.Tensor, k: int):
    """Row-wise top-k by magnitude. x: (..., d) f32|bf16 -> (values (..., k)
    in x.dtype, indices (..., k) int32 ascending). d <= 256 on the card."""
    d = x.shape[-1]
    _build.refuse_grad("rtopk", x)
    if x.device.type == "cpu":
        return rtopk_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"rtopk runs on cuda or cpu tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rtopk kernel takes float32/bfloat16, got {x.dtype}")
    if not 0 < k <= d or d > 256:
        raise ValueError(f"rtopk kernel needs 0 < k <= d <= 256, got k={k}, d={d}")
    x = x.contiguous()
    lead = x.shape[:-1]
    rows = x.numel() // d
    vals = torch.empty(lead + (k,), dtype=x.dtype, device=x.device)
    idx = torch.empty(lead + (k,), dtype=torch.int32, device=x.device)
    fn = _build.entry("rtopk", "rtopk_launch", _ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, d, k,
                 _DTYPES[x.dtype], _build.stream_ptr(x))
    _build.check("rtopk", err, "rtopk launch")
    rtopk.launches += 1
    return vals, idx


rtopk.launches = 0
