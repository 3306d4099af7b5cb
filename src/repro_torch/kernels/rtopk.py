"""rtopk: row-wise exact top-|k| on IEEE-754 bit patterns, and
proj_rtopk: the fused head projection -> [RoPE] -> top-k.

Replaces the TPU kernel ``repro/kernels/rtopk.py::rtopk`` (Pallas body
``_rtopk_kernel`` -> ``_topk_select``) with the CUDA kernel in
``csrc/rtopk.cu``, whose selection code lives in ``csrc/topk_select.cuh``
(shared with proj_rtopk): ties kept in ascending index order, values moved
bit-exact as raw bits, NaN read as +0. It has two bodies, picked by shape
alone (``one_thread_body``):

  * d in ``THREAD_HEAD_DIMS`` and k <= ``THREAD_MAX_K`` (every path of the
    port's models) — one thread a row: a warp stages its rows, one
    contiguous span of x, in shared memory at a bank-spreading pitch; a
    thread keeps the k largest keys of its row in a descending register
    list (8 or 16 long, merged in groups of 8). bf16 keys carry their index,
    so the list's first k are the codes; f32 takes the k-th as a threshold
    and writes the entries above it and the first ties in index order. The
    warp's codes leave as two contiguous spans. Lanes split a row and
    merge their lists by shuffles, as many as ``csrc/rtopk.cu``'s
    ``by_rows`` picks from the dtype and the row count (1 or 2 at a
    training step's rows, 4 or 8 below kManyRows);
  * the other shapes (k > 16, other d <= 256) — the warp body: one warp a
    row, the exact bisection over the magnitude bits counted with
    ``__ballot_sync``/``__popc`` (16 steps on bf16, 32 on f32);
    ``rtopk.warp_body_launches`` counts it (``kernels.body_counts()``).

Bound on the H100: bytes (the row is read once, k values and k int32
indices are written).

``proj_rtopk`` replaces the TPU kernel ``repro/kernels/rtopk.py::proj_rtopk``
(Pallas body ``_proj_rtopk_kernel``, ``_rope_tile``) with the CUDA kernels
in ``csrc/proj_rtopk.cu`` (d 32, 64, 128) and ``csrc/proj_rtopk_wide.cu``
(d in ``WIDE_HEAD_DIMS``: 80, 256; ``library`` names the source), which
pick their body by dtype and shape alone (``tensor_core_body``):

  * bf16 x with d in ``PROJ_HEAD_DIMS`` and m a multiple of 8 — the tensor
    cores: Y = X·W as one GEMM on wgmma, a block owning 128 tokens × 128
    columns (128/d heads), x and w by TMA in chunks of 64 of m; w rounded
    to bf16 as contiguous (m, H·d) by a pack kernel once per call (a bf16
    w with adjacent heads and 16-byte rows goes to TMA in place). At d 80
    and 256 a block owns whole heads, 160 or 256 columns, and the pack
    kernel writes wᵀ as (H·d, m) rows, which wgmma reads K-major;
  * f32 (on the tensor cores f32 would be TF32, which fails 1e-4) and the
    other shapes — the CUDA-core body: one block per (64-token tile, head,
    batch row), the (64, d) product in f32 registers, w read in place
    through its strides; ``proj_rtopk.cuda_core_launches`` counts it
    (``kernels.body_counts()``).

Both round the f32 product to x's dtype into shared memory, apply RoPE when
asked, and select each row's top-k with ``csrc/topk_select.cuh``, rtopk's
choice and tie order: one warp a row by the warp-ballot bisection, or in
the tensor-core body, for k <= 16, one thread a row keeping the k largest
magnitudes in registers. Only the codes reach device memory: the dense
(n, d) q/k of the unfused path is never written. Bound on the H100: operations
(the 2·m·d flops of the projection per row and head).

The plain versions are ``kernels/ref.py::rtopk_ref`` (a bisection in torch
ops, the same choice) and ``::proj_rtopk_ref`` (einsum, rope, rtopk_ref); the wrappers
run them for CPU tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import proj_rtopk_ref as proj_rtopk_plain
from repro_torch.kernels.ref import rope_freqs
from repro_torch.kernels.ref import rtopk_ref as rtopk_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


MAX_D = 256                    # rtopk's largest row width
THREAD_HEAD_DIMS = (32, 64, 128)  # the row widths of rtopk's one-thread body
THREAD_MAX_K = 16                 # and its largest k
PROJ_HEAD_DIMS = (32, 64, 80, 128, 256)  # proj_rtopk's head dims d, either body
WIDE_HEAD_DIMS = (80, 256)      # of them, those built apart (csrc/proj_rtopk_wide.cu)

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def one_thread_body(d: int, k: int) -> bool:
    """Does ``rtopk`` run its one-thread body on rows of width d at this k
    (else the warp body)?"""
    return d in THREAD_HEAD_DIMS and k <= THREAD_MAX_K


def rtopk(x: torch.Tensor, k: int):
    """Row-wise top-k by magnitude. x: (..., d) f32|bf16 -> (values (..., k)
    in x.dtype, indices (..., k) int32 ascending). d <= 256 on the card; the
    shape picks the body (``one_thread_body``)."""
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
    one = one_thread_body(d, k)
    x = x.contiguous()
    if one and x.data_ptr() % 16:   # the one-thread body stages 16-byte chunks
        x = x.clone()
    lead = x.shape[:-1]
    rows = x.numel() // d
    vals = torch.empty(lead + (k,), dtype=x.dtype, device=x.device)
    idx = torch.empty(lead + (k,), dtype=torch.int32, device=x.device)
    fn = _build.entry("rtopk", "rtopk_launch", _ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, d, k,
                 _DTYPES[x.dtype], int(one), _build.stream_ptr(x))
    _build.check("rtopk", err, "rtopk launch")
    rtopk.launches += 1
    if not one:
        rtopk.warp_body_launches += 1
    return vals, idx


rtopk.launches = 0             # either body
rtopk.warp_body_launches = 0   # the warp body


_PROJ_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
              + [ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int] * 3
              + [ctypes.c_void_p])
_PROJ_TC_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
                 + [ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int] * 2
                 + [ctypes.c_void_p])


def tensor_core_body(dtype, d: int, m: int) -> bool:
    """Does ``proj_rtopk`` run the tensor-core body for x of this dtype and
    this shape? (bf16, d in PROJ_HEAD_DIMS, m a multiple of 8: the rows of
    x and w that a TMA tile reads sit on 16 bytes.)"""
    return dtype == torch.bfloat16 and d in PROJ_HEAD_DIMS and m % 8 == 0


def library(d: int) -> str:
    """The source (``csrc/<name>.cu``) whose library holds proj_rtopk's
    bodies at head dim d."""
    return "proj_rtopk_wide" if d in WIDE_HEAD_DIMS else "proj_rtopk"


def w_in_place(w_heads: torch.Tensor) -> bool:
    """Can the tensor-core body's TMA read this (H, m, d) weight view as it
    lies, as the (m, H·d) matrix of its rows? (bf16, the heads side by
    side, 16-byte rows on a 16-byte base.) Otherwise a pack kernel writes
    that matrix in bf16 first."""
    return (w_heads.dtype == torch.bfloat16 and w_heads.stride(0) == w_heads.shape[-1]
            and w_heads.stride(1) % 8 == 0 and w_heads.data_ptr() % 16 == 0)


def _rope_args(positions, rope_spec, b, n, d, device):
    """(positions (b, n) int32, the pairs' frequency table, rot_dim): the
    table ``models.layers.rope`` turns by (``ref.rope_freqs``), computed on
    the card, so the kernels' angles carry the plain version's bits."""
    if rope_spec is None:
        return None, None, 0
    if positions is None:
        raise ValueError("proj_rtopk: rope_spec needs positions")
    theta, rot = float(rope_spec[0]), int(rope_spec[1])
    if rot <= 0 or rot > d or rot % 2:
        raise ValueError(f"proj_rtopk: rot_dim {rot} must be even and <= d={d}")
    pos = torch.as_tensor(positions, device=device).expand(b, n).to(torch.int32).contiguous()
    return pos, rope_freqs(theta, rot, device), rot


def _proj_tensor_core(x, w_heads, pos, k, freqs, rot, vals, idx):
    """The tensor-core body on checked bf16 x."""
    b, n, m = x.shape
    nh, _, d = w_heads.shape
    x = _build.tma_operand(x)
    lib = library(d)
    # the wide body always packs (wᵀ, (nh·d, m)); the other packs (m, nh·d)
    # unless TMA reads w as it lies
    wpack = (None if lib == "proj_rtopk" and w_in_place(w_heads) else
             torch.empty((m * nh * d,), dtype=torch.bfloat16, device=x.device))
    fn = _build.entry(lib, "proj_rtopk_tc_launch", _PROJ_TC_ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w_heads.data_ptr(),
                 pos.data_ptr() if pos is not None else None, vals.data_ptr(),
                 idx.data_ptr(), wpack.data_ptr() if wpack is not None else None, b, n, m,
                 nh, d, w_heads.stride(0), w_heads.stride(1), k,
                 freqs.data_ptr() if freqs is not None else None, rot,
                 _DTYPES[w_heads.dtype], _build.stream_ptr(x))
    _build.check(lib, err, "proj_rtopk (tensor cores) launch")


def _proj_cuda_core(x, w_heads, pos, k, freqs, rot, vals, idx):
    """The CUDA-core body on checked inputs."""
    b, n, m = x.shape
    nh, _, d = w_heads.shape
    x = x.contiguous()
    lib = library(d)
    fn = _build.entry(lib, "proj_rtopk_launch", _PROJ_ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w_heads.data_ptr(),
                 pos.data_ptr() if pos is not None else None, vals.data_ptr(),
                 idx.data_ptr(), b, n, m, nh, d, w_heads.stride(0), w_heads.stride(1),
                 k, freqs.data_ptr() if freqs is not None else None, rot,
                 _DTYPES[x.dtype], _DTYPES[w_heads.dtype],
                 _build.stream_ptr(x))
    _build.check(lib, err, "proj_rtopk launch")


def proj_rtopk(x: torch.Tensor, w_heads: torch.Tensor, positions=None, *, k: int,
               rope_spec=None):
    """Fused head projection -> [RoPE] -> top-k, only the codes written.

    x (b, n, m) activations; w_heads (H, m, d) per-head projection blocks
    (any strides with unit stride on d: a per-head view of a packed weight
    is read in place, or packed once per call by the tensor-core body);
    positions (b, n) int, needed with ``rope_spec = (theta, rot_dim)``.
    Returns (values (b, H, n, k) in x.dtype, indices (b, H, n, k) int32
    ascending) = rtopk of rope(x @ w_h.to(x.dtype)), the product summed in
    f32 and rounded to x.dtype. On the card x and w are f32 or bf16 and d
    is in ``PROJ_HEAD_DIMS``; the dtype and shape pick the body
    (``tensor_core_body``).
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
    pos, freqs, rot = _rope_args(positions, rope_spec, b, n, d, x.device)
    vals = torch.empty((b, nh, n, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((b, nh, n, k), dtype=torch.int32, device=x.device)
    if tensor_core_body(x.dtype, d, m):
        _proj_tensor_core(x, w_heads, pos, k, freqs, rot, vals, idx)
    else:
        _proj_cuda_core(x, w_heads, pos, k, freqs, rot, vals, idx)
        proj_rtopk.cuda_core_launches += 1
    proj_rtopk.launches += 1
    return vals, idx


proj_rtopk.launches = 0             # either body
proj_rtopk.cuda_core_launches = 0   # the CUDA-core body
