"""rtopk: row-wise exact top-|k| by bisection on IEEE-754 bit patterns, and
proj_rtopk: the fused head projection -> [RoPE] -> top-k.

Replaces the TPU kernel ``repro/kernels/rtopk.py::rtopk`` (Pallas body
``_rtopk_kernel`` -> ``_topk_select``) with the CUDA kernel in
``csrc/rtopk.cu``: one warp per row, the row strided across lanes, the
exact 32-step bisection counted with ``__ballot_sync``/``__popc``, ties kept
in ascending index order, values moved bit-exact, NaN read as +0.

Bound on the H100: bytes (the row is read once, k values and k int32
indices are written; the bisection runs on registers). The design keeps the
whole row in one warp's registers so each of the 32 steps is a few ballots
with no shared memory or shuffles.

``proj_rtopk`` replaces the TPU kernel ``repro/kernels/rtopk.py::proj_rtopk``
(Pallas body ``_proj_rtopk_kernel``, ``_rope_tile``) with the CUDA kernel in
``csrc/proj_rtopk.cu``: one block per (64-token tile, head, batch row)
builds the (64, d) projection in f32 from x and the head's columns of w
(read in place through strides), rounds it to x's dtype, applies RoPE when
asked, and selects each row's top-k with the same warp-ballot bisection and
tie order as rtopk. Only the codes reach device memory: the dense (n, d)
q/k of the unfused path is never written. Bound on the H100: operations
(the 2·m·d flops of the projection per row and head, on CUDA cores in f32
here; the tensor cores are a later change).

The plain versions are ``kernels/ref.py::rtopk_ref`` (the same bisection in
torch ops) and ``::proj_rtopk_ref`` (einsum, rope, rtopk_ref); the wrappers
run them for CPU tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import proj_rtopk_ref as proj_rtopk_plain
from repro_torch.kernels.ref import rtopk_ref as rtopk_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


MAX_D = 256                    # rtopk's largest row width
PROJ_HEAD_DIMS = (32, 64, 128)  # proj_rtopk's head dims d

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
    if not 0 < k <= d or d > MAX_D:
        raise ValueError(f"rtopk kernel needs 0 < k <= d <= {MAX_D}, got k={k}, d={d}")
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


_PROJ_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
              + [ctypes.c_int] + [ctypes.c_float] + [ctypes.c_int] * 3
              + [ctypes.c_void_p])


def proj_rtopk(x: torch.Tensor, w_heads: torch.Tensor, positions=None, *, k: int,
               rope_spec=None):
    """Fused head projection -> [RoPE] -> top-k, only the codes written.

    x (b, n, m) activations; w_heads (H, m, d) per-head projection blocks
    (any strides with unit stride on d: a per-head view of a packed weight
    is read in place); positions (b, n) int, needed with
    ``rope_spec = (theta, rot_dim)``. Returns (values (b, H, n, k) in
    x.dtype, indices (b, H, n, k) int32 ascending) = rtopk of
    rope(x @ w_h.to(x.dtype)), the product summed in f32 and rounded to
    x.dtype. On the card x and w are f32 or bf16 and d is 32, 64 or 128.
    """
    _build.refuse_grad("proj_rtopk", x, w_heads)
    if x.device.type == "cpu":
        return proj_rtopk_plain(x, w_heads, positions, k=k, rope_spec=rope_spec)
    if x.device.type != "cuda":
        raise ValueError(f"proj_rtopk runs on cuda or cpu tensors, got {x.device}")
    b, n, m = x.shape
    nh, m2, d = w_heads.shape
    if (m2 != m or x.dtype not in _DTYPES or w_heads.dtype not in _DTYPES
            or d not in PROJ_HEAD_DIMS or not 0 < k <= d or w_heads.stride(-1) != 1
            or w_heads.device != x.device):
        raise ValueError(f"proj_rtopk kernel takes x (b, n, m) and w (H, m, d) in "
                         f"f32/bf16 on one device, unit stride on d, d in {PROJ_HEAD_DIMS} "
                         f"and 0 < k <= d; got x {tuple(x.shape)} {x.dtype}, w "
                         f"{tuple(w_heads.shape)} {w_heads.dtype} strides "
                         f"{w_heads.stride()}, k={k}")
    pos = None
    theta, rot = 0.0, 0
    if rope_spec is not None:
        if positions is None:
            raise ValueError("proj_rtopk: rope_spec needs positions")
        theta, rot = float(rope_spec[0]), int(rope_spec[1])
        if rot <= 0 or rot > d or rot % 2:
            raise ValueError(f"proj_rtopk: rot_dim {rot} must be even and <= d={d}")
        pos = torch.as_tensor(positions, device=x.device).expand(b, n).to(
            torch.int32).contiguous()
    x = x.contiguous()
    vals = torch.empty((b, nh, n, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((b, nh, n, k), dtype=torch.int32, device=x.device)
    fn = _build.entry("proj_rtopk", "proj_rtopk_launch", _PROJ_ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w_heads.data_ptr(),
                 pos.data_ptr() if pos is not None else None, vals.data_ptr(),
                 idx.data_ptr(), b, n, m, nh, d, w_heads.stride(0), w_heads.stride(1),
                 k, theta, rot, _DTYPES[x.dtype], _DTYPES[w_heads.dtype],
                 _build.stream_ptr(x))
    _build.check("proj_rtopk", err, "proj_rtopk launch")
    proj_rtopk.launches += 1
    return vals, idx


proj_rtopk.launches = 0
