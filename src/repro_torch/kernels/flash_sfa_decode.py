"""FlashSFA decode: one query against the token-major sparse KV cache.

Replaces the TPU kernel ``repro/kernels/flash_sfa_decode.py::flash_sfa_decode``
(Pallas body ``_decode_kernel``) with the CUDA kernel in
``csrc/flash_sfa_decode.cu``: one block per (batch, head), the query staged
in shared memory, each warp scoring its cache tokens by gathering the query
at the token's k stored indices (s_j = scale·Σ_t kv[j,t]·q[ki[j,t]]),
online softmax per warp, V accumulated in f32, and one merge of the warps
at the end. Output is f32.

Bound on the H100: bytes — Σ len·hkv·(k·(val + idx bytes) + dv·val bytes)
per layer. The design reads the ``SparseKV`` leaves in place through their
strides: packed uint8/uint16 indices, bf16 values, head h reading kv head
h // group. The JAX package's contiguous path copies the whole cache every
step to unpack the indices, repeat the GQA heads and upcast V
(``repro/models/backends.py:431-438``); the port makes none of those
copies, with the same numbers. The grid is b·h blocks (96 for gpt2-small at
8 slots, under the 132 SMs); split-K is work for a later change.

The plain version is ``kernels/ref.py::flash_sfa_decode_ref``; the wrapper
runs it for CPU tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_sfa_decode_ref as flash_sfa_decode_plain

_VALS = {torch.float32: 0, torch.bfloat16: 1}
_IDX = {torch.uint8: 0, torch.uint16: 1, torch.int32: 2}


_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9
         + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _layout(t, name):
    """(batch, n, kv_heads, strides b/n/h) of a 3-D (bh, n, F) or 4-D
    (b, n, hkv, F) cache leaf; the last axis must be contiguous."""
    if t.stride(-1) != 1:
        raise ValueError(f"flash_sfa_decode: {name} needs a contiguous last axis")
    if t.ndim == 3:
        return t.shape[0], t.shape[1], 1, (t.stride(0), t.stride(1), 0)
    if t.ndim == 4:
        return t.shape[0], t.shape[1], t.shape[2], (t.stride(0), t.stride(1),
                                                    t.stride(2))
    raise ValueError(f"flash_sfa_decode: {name} must be 3-D or 4-D, got "
                     f"{tuple(t.shape)}")


def flash_sfa_decode(q, k_vals, k_idx, v, lengths, *, d: int,
                     scale: float | None = None):
    """Token-major sparse-cache decode -> (bh, dv) f32.

    q: (bh, d) dense (top-k sparsified) query; lengths: (bh,) valid prefix
    per query row. Cache leaves are the JAX kernel's folded (bh, n_max, k) /
    (bh, n_max, dv), or the ``SparseKV`` leaves (b, n_max, hkv, k) /
    (b, n_max, hkv, dv) as they are, with bh = b·h and query row b·h + j
    reading kv head j // (h // hkv). Indices may be uint8, uint16 or int32.
    """
    scale = float(scale if scale is not None else d ** -0.5)
    _build.refuse_grad("flash_sfa_decode", q, k_vals, v)
    if q.device.type == "cpu":
        return flash_sfa_decode_plain(q, k_vals, k_idx, v, lengths, d=d,
                                      scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_sfa_decode runs on cuda or cpu tensors, got {q.device}")
    if k_vals.dtype not in _VALS or v.dtype != k_vals.dtype:
        raise TypeError(f"flash_sfa_decode kernel takes f32/bf16 k_vals and v of "
                        f"one dtype, got {k_vals.dtype}/{v.dtype}")
    if k_idx.dtype not in _IDX:
        raise TypeError(f"flash_sfa_decode: k_idx dtype {k_idx.dtype} not in {list(_IDX)}")
    b, n_max, hkv, skv = _layout(k_vals, "k_vals")
    lay_i, lay_v = _layout(k_idx, "k_idx"), _layout(v, "v")
    if lay_i[:3] != (b, n_max, hkv) or lay_v[:3] != (b, n_max, hkv):
        raise ValueError("flash_sfa_decode: k_vals, k_idx and v disagree on "
                         "(batch, tokens, kv heads)")
    kk, dv = k_vals.shape[-1], v.shape[-1]
    if k_idx.shape[-1] != kk or dv not in (32, 64, 128):
        raise ValueError(f"flash_sfa_decode: k_idx width {k_idx.shape[-1]} vs "
                         f"{kk}, dv={dv} (kernel takes 32, 64 or 128)")
    bh = q.shape[0]
    if q.shape != (bh, d) or bh % b or (bh // b) % hkv:
        raise ValueError(f"flash_sfa_decode: q {tuple(q.shape)} does not fit "
                         f"batch {b} x heads (multiple of {hkv}) x d {d}")
    for t in (k_vals, k_idx, v):
        if t.device != q.device:
            raise ValueError("flash_sfa_decode: inputs on different devices")
    q = q.float().contiguous()
    lens = torch.as_tensor(lengths, device=q.device).to(torch.int32).contiguous()
    if lens.shape != (bh,):
        raise ValueError(f"flash_sfa_decode: lengths {tuple(lens.shape)}, expected ({bh},)")
    out = torch.empty((bh, dv), dtype=torch.float32, device=q.device)
    fn = _build.entry("flash_sfa_decode", "flash_sfa_decode_launch", _ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_vals.data_ptr(), k_idx.data_ptr(), v.data_ptr(),
                 lens.data_ptr(), out.data_ptr(), b, bh // b, hkv, kk, d, dv,
                 n_max, *skv, *lay_i[3], *lay_v[3], scale, _VALS[v.dtype],
                 _IDX[k_idx.dtype], _build.stream_ptr(q))
    _build.check("flash_sfa_decode", err, "flash_sfa_decode launch")
    flash_sfa_decode.launches += 1
    return out


flash_sfa_decode.launches = 0
