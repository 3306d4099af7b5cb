"""FlashSFA forward: tiled online-softmax attention over top-k codes.

Replaces the TPU kernel ``repro/kernels/flash_sfa.py::flash_sfa``, both
schedules (``block_skip=False``: Pallas body ``_flash_sfa_kernel``, helpers
``_tile_update``, ``_finalize_tile``, ``_densify_block``; ``block_skip=True``:
``_flash_sfa_skip_kernel`` with its XLA pre-pass ``_tile_occupancy`` /
``_block_maps``), with two CUDA bodies chosen by dtype and shape:

* bf16 with d = dv in {32, 64, 80, 128, 256} and k <= 32, either
  schedule — the tensor-core body
  (``csrc/flash_sfa_tc.cuh`` on ``csrc/attention_tc.cuh``, the dense bf16
  forward's schedule; built from ``flash_sfa_tc.cu``, and at 80 and 256
  from ``flash_sfa_tc_wide.cu``): one block of two warpgroups per (bh,
  128-query tile); the query codes densified once into a swizzled
  shared-memory tile, each 64-key tile's codes staged one tile ahead
  (cp.async, beside V's TMA load) and densified the same way, as the TPU
  densifies in VMEM; S = Q̃·K̃ᵀ and P·V as ``wgmma`` with the online softmax
  in registers and P split into bf16 hi + lo. A pack kernel first turns
  each code into one 32-bit word. At d 80 the tiles are 96 columns wide
  (zeros past 80); at d 256 a block's two warpgroups share 64 query rows,
  each computing the whole S and one 128-column half of O. Bound on the
  H100: operations, now on the tensor cores (4·d flops per (query, key)
  pair, 6·d with the split).
* f32, and bf16 shapes outside that set (d ≠ dv, k > 32) — the CUDA-core
  body of
  ``csrc/flash_sfa.cu``: one block per (bh, 64-query tile), each key tile
  densified into shared memory as (64 × d) f32, scores gathered at each
  query's own k coordinates (k multiply-adds per score), online softmax
  and P·V in f32 on CUDA cores. It is the exact f32 path: f32 on the
  tensor cores would be TF32 (~3 decimal digits), which fails f32's 1e-4.

The dtype and shape alone choose the body (``tensor_core_body``); no
caller picks one. ``flash_sfa.launches`` and ``.block_skip_launches`` count
the launches of either body by schedule (one PERF.md row each);
``flash_sfa.cuda_core_launches`` counts those of the CUDA-core body alone.

Block skip (``block_skip=True``): ``_block_maps`` builds, in torch outside
the kernel as the JAX package does in XLA, a level map per (query tile, key
tile) at the kernels' 64 × 64 tile (the tensor-core body's warpgroup reads
the level of its own 64 rows): 0 = causally dead, 1 = the two tiles'
feature occupancies (``_tile_occupancy``, value-zero entries excluded) do
not intersect on a fully visible tile, so every score is 0 and the kernel
applies the closed-form online-softmax update from the tile's V row sum
without reading its K codes or V; 2 = compute. The TPU's ``fetch`` map
(which K/V block to DMA at each grid step) has no counterpart: it only
keeps the TPU pipeline from copying skipped blocks, and a CUDA block loads
only the tiles it computes. The level map does not change the function, so
the plain version of both schedules is the same ``flash_sfa_ref``. At d 64
and k 8 a 64-row tile occupies nearly all 64 features, so level 1 is rare
on real codes; ``block_skip_stats`` reports the map's shares.

The plain version is ``kernels/ref.py::flash_sfa_ref`` (densify, matmul,
mask, softmax); the wrapper runs it for CPU tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_sfa_ref as flash_sfa_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_TC_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float]
            + [ctypes.c_int] + [ctypes.c_void_p])
BLOCK = 64          # the kernels' level-map tile (csrc/flash_sfa.cu kBQ = kBK; a warpgroup)
# the shapes the forward's bodies take (models/backends.py reads them)
V_HEAD_DIMS = (32, 64, 80, 128, 256)  # dv, either body
MAX_D = 256                   # d, either body
TC_DIMS = (32, 64, 80, 128, 256)  # d = dv of the tensor-core bodies
# their widths built apart (csrc/flash_sfa_tc_wide.cu)
WIDE_DIMS = (80, 256)
TC_MAX_K = 32                 # their largest code width


def tensor_core_body(dtype, d: int, dv: int, kq: int, kk: int) -> bool:
    """Whether a call on the card runs the tensor-core body (the forward,
    either schedule, and the backward alike): bf16 with d = dv in
    ``TC_DIMS`` and k <= 32."""
    return (dtype == torch.bfloat16 and d == dv and dv in TC_DIMS
            and 0 < kq <= TC_MAX_K and 0 < kk <= TC_MAX_K)


def tc_library(d: int) -> str:
    """The source (``csrc/<name>.cu``) whose library holds the tensor-core
    body at d."""
    return "flash_sfa_tc_wide" if d in WIDE_DIMS else "flash_sfa_tc"


def packed_scratch(bh: int, nq: int, kq: int, nk: int, kk: int, device):
    """The tensor-core bodies' scratch: one 32-bit word per code of both sides."""
    return torch.empty(bh * (nq * kq + nk * kk), dtype=torch.int32, device=device)


def _tile_occupancy(vals, idx, d: int, nblocks: int, block: int):
    """(bh, nblocks·block, k) codes -> (bh, nblocks, d) f32 0/1 feature
    occupancy of each tile. Entries with value 0 are left out: they add
    nothing to any score, and padded rows (idx 0 × k, val 0) would
    otherwise pin feature 0. Indices outside [0, d) are dropped."""
    bh, _, kq = idx.shape
    flat = idx.reshape(bh, nblocks, block * kq).long()
    live = (vals.reshape(bh, nblocks, block * kq) != 0).float()
    ok = (flat >= 0) & (flat < d)
    occ = torch.zeros((bh, nblocks, d), dtype=torch.float32, device=idx.device)
    return occ.scatter_reduce_(-1, torch.where(ok, flat, 0),
                               torch.where(ok, live, 0.0), reduce="amax")


def _block_maps(q_vals, q_idx, k_vals, k_idx, *, d: int, causal: bool,
                block_q: int, block_k: int, nq_real: int, nk_real: int):
    """Level map (bh, nqb, nkb) int32 of the block-skip schedule, on codes
    padded to whole tiles: 0 dead (a query tile wholly past nq_real, or
    wholly in the causal future), 1 zero feature overlap on a tile with no
    padded key that every row sees (closed form), 2 compute. The JAX
    version also returns a DMA ``fetch`` map, which has no use here."""
    nqb = q_idx.shape[1] // block_q
    nkb = k_idx.shape[1] // block_k
    occ_q = _tile_occupancy(q_vals, q_idx, d, nqb, block_q)
    occ_k = _tile_occupancy(k_vals, k_idx, d, nkb, block_k)
    overlap = torch.einsum("bqd,bkd->bqk", occ_q, occ_k) > 0.5
    dev = q_idx.device
    qs = torch.arange(nqb, device=dev)[:, None] * block_q
    ks = torch.arange(nkb, device=dev)[None, :] * block_k
    dead = (qs >= nq_real).expand(nqb, nkb)
    full = (ks + block_k <= nk_real).expand(nqb, nkb)
    if causal:
        dead = dead | (ks > qs + block_q - 1)
        full = full & (ks + block_k - 1 <= qs)
    level = torch.where(dead[None], 0, torch.where(full[None] & ~overlap, 1, 2))
    return level.to(torch.int32)


def _pad_rows(t, block):
    pad = (-t.shape[1]) % block
    return torch.nn.functional.pad(t, (0, 0, 0, pad)) if pad else t


def _skip_schedule(q_vals, q_idx, k_vals, k_idx, *, d, causal, block_q, block_k):
    nq, nk = q_vals.shape[1], k_vals.shape[1]
    return _block_maps(_pad_rows(q_vals, block_q), _pad_rows(q_idx, block_q),
                       _pad_rows(k_vals, block_k), _pad_rows(k_idx, block_k),
                       d=d, causal=causal, block_q=block_q, block_k=block_k,
                       nq_real=nq, nk_real=nk)


def block_skip_stats(q_vals, q_idx, k_vals, k_idx, *, d: int,
                     causal: bool = True, block_q: int = BLOCK,
                     block_k: int = BLOCK):
    """Shares of the (query tile, key tile) steps that are dead (level 0),
    closed-form zero overlap (level 1) and computed (level 2), on unpadded
    codes; the kernel's map is the one at 64 × 64."""
    level = _skip_schedule(q_vals, q_idx, k_vals, k_idx, d=d, causal=causal,
                           block_q=block_q, block_k=block_k)
    total = level.numel()
    return tuple(float((level == lv).sum()) / total for lv in (0, 1, 2))


def _check(name, t, shape, dtype):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"flash_sfa: {name} is {tuple(t.shape)} {t.dtype}, "
                         f"expected {tuple(shape)} {dtype}")


def flash_sfa(q_vals, q_idx, k_vals, k_idx, v, *, d: int, causal: bool = True,
              scale: float | None = None, return_residuals: bool = False,
              block_skip: bool = False):
    """FlashSFA forward. Codes (bh, n, k) values + indices; v (bh, nk, dv)
    -> out (bh, nq, dv) in v.dtype [, lse (bh, nq) f32].

    Exactly softmax(densify(Q̃)·densify(K̃)ᵀ·scale + causal)·V, with either
    schedule (``block_skip``: skip dead and zero-overlap tiles). On the card
    the code values and v share one dtype (f32 or bf16), indices are int32,
    d <= 256 and dv is in ``V_HEAD_DIMS``. bf16 with d = dv in ``TC_DIMS``
    and k <= 32 runs the tensor-core body (either schedule), everything
    else the CUDA-core body.
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
    if dt not in _DTYPES or dv not in V_HEAD_DIMS or not 0 < d <= MAX_D:
        raise ValueError(f"flash_sfa kernel takes f32/bf16 with dv in {V_HEAD_DIMS} "
                         f"and d <= {MAX_D}, got {dt}, dv={dv}, d={d}")
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
    level = vsum = None
    if block_skip:
        level = _skip_schedule(q_vals, q_idx, k_vals, k_idx, d=d, causal=causal,
                               block_q=BLOCK, block_k=BLOCK).contiguous()
        vsum = _pad_rows(v, BLOCK).float().reshape(bh, -1, BLOCK, dv).sum(2)
    ptrs = (lse.data_ptr() if lse is not None else None,
            level.data_ptr() if level is not None else None,
            vsum.data_ptr() if vsum is not None else None)
    if tensor_core_body(dt, d, dv, kq, kk):
        v = _build.tma_operand(v)
        packed = packed_scratch(bh, nq, kq, nk, kk, v.device)
        lib = tc_library(d)
        fn = _build.entry(lib, "flash_sfa_tc_fwd_launch", _TC_ARGS)
        with torch.cuda.device(v.device):
            err = fn(q_vals.data_ptr(), q_idx.data_ptr(), k_vals.data_ptr(),
                     k_idx.data_ptr(), v.data_ptr(), out.data_ptr(), *ptrs,
                     packed.data_ptr(), bh, nq, nk, kq, kk, d, scale, int(causal),
                     _build.stream_ptr(v))
        _build.check(lib, err, "flash_sfa launch")
    else:
        fn = _build.entry("flash_sfa", "flash_sfa_fwd_launch", _ARGS)
        with torch.cuda.device(v.device):
            err = fn(q_vals.data_ptr(), q_idx.data_ptr(), k_vals.data_ptr(),
                     k_idx.data_ptr(), v.data_ptr(), out.data_ptr(), *ptrs,
                     bh, nq, nk, kq, kk, d, dv, scale, int(causal), _DTYPES[dt],
                     _build.stream_ptr(v))
        _build.check("flash_sfa", err, "flash_sfa launch")
        flash_sfa.cuda_core_launches += 1
    if block_skip:
        flash_sfa.block_skip_launches += 1
    else:
        flash_sfa.launches += 1
    return (out, lse) if return_residuals else out


flash_sfa.launches = 0              # block_skip=False, either body
flash_sfa.block_skip_launches = 0   # block_skip=True, either body
flash_sfa.cuda_core_launches = 0    # the CUDA-core body, either schedule
