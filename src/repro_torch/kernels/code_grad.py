"""Compact code-gradient consumers: the projection backward of the seam.

The FlashSFA backward with ``emit="compact"`` writes dQ̃/dK̃ as (n, k)
values aligned to the stored (n, k) indices (``"compact2"``: (n, 2k) on the
RoPE pair closure). The Q/K input-projection backward consumes them as they
are:

    dx   = Σ_h scatter(vals_h, idx_h) @ w_hᵀ     (n, m)
    dW_h = xᵀ @ scatter(vals_h, idx_h)           (m, d)

Replaces the TPU kernels ``repro/kernels/code_grad.py::code_grad_dx``
(Pallas body ``_dx_kernel``) and ``::code_grad_dw`` (``_dw_kernel``) with the
CUDA kernels in ``csrc/code_grad.cu`` (the CUDA-core bodies, and the
tensor-core ones at d 32, 64, 128) and ``csrc/code_grad_wide.cu`` (the
tensor-core ones at d in ``WIDE_HEAD_DIMS``: 80, 256; both from
``csrc/code_grad_tc.cuh``). Each code entry adds its own term,
so duplicate indices sum, as ``_densify_block`` makes them, and an index
outside [0, d) adds nothing. The dense (n, d) gradient never reaches device
memory.

Both pick their body by dtype and shape alone (``tensor_core_body``: the
codes' dtype, d, kw and m):

  * bf16 with d in ``TC_HEAD_DIMS``, kw in ``TC_KW`` (8, 16, and 32: the
    RoPE pair closure at k 16) and m a multiple of 8, but for the (d, kw)
    in ``CUDA_CORE_SHAPES`` (width 32 at d 32) — the tensor cores, as the
    TPU densified each code tile in VMEM for its matrix unit: a pack kernel resolves each code row's repeated indices
    once (a repeated index's f32 sum kept as bf16 hi + lo, the lo products
    run only when some sum needs them). dW: dWᵀ = Sᵀ·x as one GEMM over
    the token axis, each block 128 feature rows (128/d heads; a head of 80
    padded to 128, a head of 256 in two blocks) × 128 columns of m, the chunk's Sᵀ hi and lo tiles densified in shared memory, x by
    TMA; the token axis split so the blocks fill the card, then a
    fixed-order sum. dx: dx = S·Wᵀ as one GEMM over the head-feature axis,
    each block 128 tokens × 128 columns of m walking the heads in order in
    steps of 64 features (32 at d 32 and 80, the last step of a head of 80
    half zero), each step's S tile densified in shared memory, w split once per call
    into contiguous bf16 hi + lo (an f32 w rounded to bf16 alone fails
    1e-4) and read by TMA. Width 32 runs the same bodies with twice the
    packed rows a stage (dx stages them twice rather than three times, to
    stay within a block's shared memory);
  * f32 codes (on the tensor cores f32 would be TF32, which fails 1e-4) and
    the other bf16 shapes — the CUDA-core bodies: dx one block per
    (128-token tile, 64-column tile), the heads summed inside the block; dW
    one block per (head, 128-column tile, token split), each thread owning
    one row of an f32 accumulator in shared memory; both gather each
    product at the kw stored coordinates. ``code_grad_dx.cuda_core_launches``
    and ``code_grad_dw.cuda_core_launches`` count them
    (``kernels.body_counts()``).

Every output has one owner and one summation order: no atomics, a
deterministic result.

Bound on the H100: operations, for each of dx and dW the lesser of 2·kw
flops per (token, column, head) on CUDA cores and 2·d on the tensor cores;
the bytes are x, w and the codes once each plus the f32 outputs.

The weight blocks are read in place through their strides (unit stride on
d), so a per-head view of the packed ``w_qkv`` needs no copy.

The plain versions are ``kernels/ref.py::code_grad_dx_ref`` and
``::code_grad_dw_ref`` (densify, then the matrix product); the wrappers run
them for CPU tensors only. ``scatter_code_grads`` is the exact (…, k) ->
(…, d) inverse of the compact emit, for callers that need dense rows.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import code_grad_dw_ref as code_grad_dw_plain
from repro_torch.kernels.ref import code_grad_dx_ref as code_grad_dx_plain
from repro_torch.kernels.ref import scatter_code_grads

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_KW = 64
_DX_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
            + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_DX_TC_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
               + [ctypes.c_int] + [ctypes.c_void_p])
_DW_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_DW_TC_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_DW_SPLIT_TOKENS = 1024     # CUDA-core dW: tokens per split of the contraction
_DW_MAX_SPLITS = 8          # either dW body: most token splits
TC_HEAD_DIMS = (32, 64, 80, 128, 256)   # d of the tensor-core bodies
WIDE_HEAD_DIMS = (80, 256)     # of them, those built apart (csrc/code_grad_wide.cu)
TC_KW = (8, 16, 32)            # their code widths
# (d, kw) of those that run the CUDA-core bodies (csrc tc_shape): at d 32 a
# dW chunk holds 256 packed rows, and four stages of 32-wide ones need
# 328,736 bytes of shared memory, over the 232,448 a block may use. No full
# config emits width 32 at d 32 (the k-16 RoPE configs have d 128 or 256).
CUDA_CORE_SHAPES = ((32, 32),)
_TC_TILE = 128                 # its block: feature rows and columns of m (csrc kTcRows, kTcCols)
_TC_TOK = 64                   # its chunk of tokens (csrc kTcTok)
_TC_MIN_CHUNKS = 4             # chunks a token split walks at least


def tensor_core_body(dtype, d: int, kw: int, m: int) -> bool:
    """Do ``code_grad_dx`` and ``code_grad_dw`` run their tensor-core
    bodies for codes of this dtype and this shape? (bf16, d in
    TC_HEAD_DIMS, kw in TC_KW, (d, kw) not in CUDA_CORE_SHAPES, m a multiple
    of 8: the rows of x, and of the w tiles, that a TMA tile reads sit on
    16 bytes.)"""
    return (dtype == torch.bfloat16 and d in TC_HEAD_DIMS and kw in TC_KW
            and (d, kw) not in CUDA_CORE_SHAPES and m % 8 == 0)


def library(d: int) -> str:
    """The source (``csrc/<name>.cu``) whose library holds the tensor-core
    bodies at head dim d (the CUDA-core ones are ``code_grad``'s)."""
    return "code_grad_wide" if d in WIDE_HEAD_DIMS else "code_grad"


def dw_feature_blocks(nh: int, d: int) -> int:
    """The tensor-core dW body's blocks along the head-feature axis (csrc
    DwRows): 128 feature rows each, whole heads of 32, 64 or 128; one head
    of 80 (rows 80-127 zero); half a head of 256."""
    if d <= _TC_TILE and _TC_TILE % d == 0:
        return -(-nh * d // _TC_TILE)
    return nh * -(-d // _TC_TILE)


def tc_splits(n: int, nh: int, d: int, m: int, sms: int):
    """(splits, split_len) of the tensor-core dW body: as many token splits
    as keep every block of one wave on its own SM (at most _DW_MAX_SPLITS,
    each at least _TC_MIN_CHUNKS chunks), split_len a whole number of
    chunks and no split empty."""
    tiles = dw_feature_blocks(nh, d) * -(-m // _TC_TILE)
    chunks = -(-n // _TC_TOK)
    splits = max(1, min(sms // tiles, chunks // _TC_MIN_CHUNKS, _DW_MAX_SPLITS))
    split_len = -(-chunks // splits) * _TC_TOK
    return -(-n // split_len), split_len


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_codes(what, vals, idx, d):
    nh, n, kw = vals.shape
    if tuple(idx.shape) != (nh, n, kw) or idx.dtype != torch.int32:
        raise ValueError(f"{what}: idx is {tuple(idx.shape)} {idx.dtype}, expected "
                         f"{(nh, n, kw)} int32")
    if vals.dtype not in _DTYPES or not 0 < kw <= _MAX_KW or not 0 < d <= 256:
        raise ValueError(f"{what} kernel takes f32/bf16 codes with 0 < kw <= {_MAX_KW} "
                         f"and d <= 256; got {vals.dtype}, kw={kw}, d={d}")


def _check_weight(what, w, d):
    if w.dtype not in _DTYPES or w.shape[-1] != d or w.stride(-1) != 1:
        raise ValueError(f"{what}: w must be (H, m, {d}) f32/bf16 with unit stride on "
                         f"d, got {tuple(w.shape)} {w.dtype} strides {w.stride()}")


def _packed_codes(vals):
    """Scratch of the pack kernel: its words (4 bytes a code), lo bits (2
    bytes a code) and the flag of a nonzero lo."""
    return torch.empty(vals.numel() * 6 + 16, dtype=torch.uint8, device=vals.device)


def _dx_tensor_core(vals, idx, w, d):
    """The tensor-core dx body on checked bf16 codes -> (n, m) f32."""
    nh, n, kw = vals.shape
    m = w.shape[1]
    vals, idx = _build.tma_operand(vals), _build.tma_operand(idx)
    out = torch.empty((n, m), dtype=torch.float32, device=vals.device)
    packed = _packed_codes(vals)
    # w as contiguous bf16 hi (and, for f32 w, lo) heads
    wsplit = torch.empty((1 if w.dtype == torch.bfloat16 else 2) * nh * m * d,
                         dtype=torch.bfloat16, device=vals.device)
    lib = library(d)
    fn = _build.entry(lib, "code_grad_dx_tc_launch", _DX_TC_ARGS)
    with torch.cuda.device(vals.device):
        err = fn(vals.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
                 packed.data_ptr(), wsplit.data_ptr(), nh, n, kw, m, d, w.stride(0),
                 w.stride(1), _DTYPES[w.dtype], _build.stream_ptr(vals))
    _build.check(lib, err, "code_grad_dx (tensor cores) launch")
    return out


def _dx_cuda_core(vals, idx, w, d):
    """The CUDA-core dx body on checked inputs -> (n, m) f32."""
    nh, n, kw = vals.shape
    m = w.shape[1]
    vals, idx = vals.contiguous(), idx.contiguous()
    out = torch.empty((n, m), dtype=torch.float32, device=vals.device)
    fn = _build.entry("code_grad", "code_grad_dx_launch", _DX_ARGS)
    with torch.cuda.device(vals.device):
        err = fn(vals.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
                 nh, n, kw, m, d, w.stride(0), w.stride(1), _DTYPES[vals.dtype],
                 _DTYPES[w.dtype], _build.stream_ptr(vals))
    _build.check("code_grad", err, "code_grad_dx launch")
    return out


def code_grad_dx(vals, idx, w, *, d: int):
    """dx = Σ_h scatter(vals_h, idx_h) @ w_hᵀ. vals/idx (H, n, kw) at any
    code width; w (H, m, d) per-head weight blocks, any strides with unit
    stride on d. Returns (n, m) f32. On the card the codes' dtype and the
    shape pick the body (``tensor_core_body``)."""
    _build.refuse_grad("code_grad_dx", vals, w)
    if vals.device.type == "cpu":
        return code_grad_dx_plain(vals, idx, w, d=d)
    if vals.device.type != "cuda":
        raise ValueError(f"code_grad_dx runs on cuda or cpu tensors, got {vals.device}")
    _check_codes("code_grad_dx", vals, idx, d)
    nh, n, kw = vals.shape
    if w.shape[0] != nh or w.device != vals.device:
        raise ValueError(f"code_grad_dx: w is {tuple(w.shape)} on {w.device}, codes "
                         f"{tuple(vals.shape)} on {vals.device}")
    _check_weight("code_grad_dx", w, d)
    m = w.shape[1]
    if tensor_core_body(vals.dtype, d, kw, m):
        out = _dx_tensor_core(vals, idx, w, d)
    else:
        out = _dx_cuda_core(vals, idx, w, d)
        code_grad_dx.cuda_core_launches += 1
    code_grad_dx.launches += 1
    return out


code_grad_dx.launches = 0             # either body
code_grad_dx.cuda_core_launches = 0   # the CUDA-core body


def _dw_tensor_core(x, vals, idx, d):
    """The tensor-core dW body on checked bf16 inputs -> (H, m, d) f32."""
    nh, n, kw = vals.shape
    m = x.shape[1]
    x, vals, idx = (_build.tma_operand(t) for t in (x, vals, idx))
    out = torch.empty((nh, m, d), dtype=torch.float32, device=vals.device)
    splits, split_len = tc_splits(n, nh, d, m, _sm_count(vals.device.index))
    part = (torch.empty((splits, nh, m, d), dtype=torch.float32, device=vals.device)
            if splits > 1 else None)
    packed = _packed_codes(vals)
    lib = library(d)
    fn = _build.entry(lib, "code_grad_dw_tc_launch", _DW_TC_ARGS)
    with torch.cuda.device(vals.device):
        err = fn(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), out.data_ptr(),
                 part.data_ptr() if part is not None else None, packed.data_ptr(), nh, n, kw,
                 m, d, splits, split_len, _build.stream_ptr(vals))
    _build.check(lib, err, "code_grad_dw (tensor cores) launch")
    return out


def _dw_cuda_core(x, vals, idx, d):
    """The CUDA-core dW body on checked inputs -> (H, m, d) f32."""
    nh, n, kw = vals.shape
    m = x.shape[1]
    x, vals, idx = x.contiguous(), vals.contiguous(), idx.contiguous()
    out = torch.empty((nh, m, d), dtype=torch.float32, device=vals.device)
    splits = max(1, min(_DW_MAX_SPLITS, n // _DW_SPLIT_TOKENS))
    part = (torch.empty((splits, nh, m, d), dtype=torch.float32, device=vals.device)
            if splits > 1 else None)
    fn = _build.entry("code_grad", "code_grad_dw_launch", _DW_ARGS)
    with torch.cuda.device(vals.device):
        err = fn(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), out.data_ptr(),
                 part.data_ptr() if part is not None else None, nh, n, kw, m, d,
                 splits, _DTYPES[vals.dtype], _build.stream_ptr(vals))
    _build.check("code_grad", err, "code_grad_dw launch")
    return out


def code_grad_dw(x, vals, idx, *, d: int):
    """dW_h = xᵀ @ scatter(vals_h, idx_h). x (n, m) projection input (the
    tokens flattened over the batch); vals/idx (H, n, kw) at any code
    width, in x's dtype on the card. Returns (H, m, d) f32. On the card the
    dtype and shape pick the body (``tensor_core_body``)."""
    _build.refuse_grad("code_grad_dw", x, vals)
    if vals.device.type == "cpu":
        return code_grad_dw_plain(x, vals, idx, d=d)
    if vals.device.type != "cuda":
        raise ValueError(f"code_grad_dw runs on cuda or cpu tensors, got {vals.device}")
    _check_codes("code_grad_dw", vals, idx, d)
    nh, n, kw = vals.shape
    if x.dim() != 2 or x.shape[0] != n or x.dtype != vals.dtype or x.device != vals.device:
        raise ValueError(f"code_grad_dw: x is {tuple(x.shape)} {x.dtype} on {x.device}, "
                         f"expected ({n}, m) {vals.dtype} on {vals.device}")
    m = x.shape[1]
    if n == 0:
        return torch.zeros((nh, m, d), dtype=torch.float32, device=vals.device)
    if tensor_core_body(vals.dtype, d, kw, m):
        out = _dw_tensor_core(x, vals, idx, d)
    else:
        out = _dw_cuda_core(x, vals, idx, d)
        code_grad_dw.cuda_core_launches += 1
    code_grad_dw.launches += 1
    return out


code_grad_dw.launches = 0             # either body
code_grad_dw.cuda_core_launches = 0   # the CUDA-core body

__all__ = ["CUDA_CORE_SHAPES", "TC_HEAD_DIMS", "TC_KW", "WIDE_HEAD_DIMS", "code_grad_dw",
           "code_grad_dx", "dw_feature_blocks", "library", "scatter_code_grads", "tc_splits",
           "tensor_core_body"]
