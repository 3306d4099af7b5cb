"""FlashSFA decode: one query against the KV cache, four layouts.

Token-major sparse cache (``csrc/flash_sfa_decode.cu``, one kernel body):

  * ``flash_sfa_decode``        (row 10) — the contiguous ``SparseKV``;
  * ``flash_sfa_decode_paged``  (row 11) — the ``PagedSparseKV`` pools
    through the block table;
  * ``flash_sfa_decode_multi``  (row 12) — the speculative verify pass: C
    queries of one slot, each at its own causal length.

Split over the keys (flash-decoding): a row's tokens fall into runs of
``SPLIT`` = 128 positions by position alone, one block per (row, run). A
block scores its run in parallel, one token a thread, by gathering the
query at the token's k stored indices (s_j = scale·Σ_t kv[j,t]·q[ki[j,t]]),
takes the run's max, p_j = exp(s_j − m), and adds p_j·V_j in f32 from the
run's V rows, which cp.async stages in shared memory while the run is
scored; each run's (m, l, acc) goes to an f32 workspace, and a second
kernel merges a row's runs in run order; output f32. The runs depend on the row's length only and only the addressing of a
token differs between the three, so the paged kernel equals the contiguous
one on the ``gather()``ed view bit for bit, and each row of the verify pass
equals the paged decode at its length.

Feature-major dense image (``csrc/flash_sfa_decode_fm.cu``, one kernel
body):

  * ``flash_sfa_decode_fm``       (row 13) — the ``FeatureMajorKV`` image;
  * ``flash_sfa_decode_fm_paged`` (row 14) — the ``PagedFeatureMajorKV``
    pools, bit-equal to row 13 on the gathered image.

Split over the keys as above, runs of ``SPLIT`` positions: threads own
tokens and sum qv[t]·K_feat[qi[t], j] in t order (each feature row one
coalesced read), the run's V rows staged by cp.async meanwhile; the runs'
partials go through the token-major decode's merge kernel
(``csrc/decode_split.cuh``).

``feature_major_prefill`` builds the persistent image from the prefill's
codes: a torch scatter, as the JAX package's is an XLA scatter.

Replaces the TPU kernels of ``repro/kernels/flash_sfa_decode.py``:
``flash_sfa_decode`` (:110), ``flash_sfa_decode_paged`` (:198),
``flash_sfa_decode_multi`` (:298), ``flash_sfa_decode_fm`` (:429) and
``flash_sfa_decode_fm_paged`` (:536). Bound on the H100: bytes — Σ
len·hkv·(k·(val + idx bytes) + dv·val bytes) per layer for the token-major
kernels, Σ len·(k·val + dv·val bytes) per query row for the feature-major
ones. Every cache leaf is read in place through its strides: packed
uint8/uint16 indices, bf16 values, head h reading kv head h // group, the
pools through the block table. The JAX package's contiguous path copies
the whole cache every step to unpack, repeat the GQA heads and upcast V
(``repro/models/backends.py:431-438``); the port makes none of those
copies. At gpt2-small's 8 slots the split gives 96 rows up to 16 blocks
each; the verify pass still reads the slot's cache once per query row.

The plain versions are in ``kernels/ref.py``; a wrapper runs its plain
version for CPU tensors only, and counts its kernel launches in
``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sparse import SparseCode, to_feature_major
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    flash_sfa_decode_fm_paged_ref, flash_sfa_decode_fm_ref,
    flash_sfa_decode_multi_ref, flash_sfa_decode_paged_ref,
)
from repro_torch.kernels.ref import flash_sfa_decode_ref as flash_sfa_decode_plain

_VALS = {torch.float32: 0, torch.bfloat16: 1}
_IDX = {torch.uint8: 0, torch.uint16: 1, torch.int32: 2}
V_HEAD_DIMS = (32, 64, 128, 256)  # dv of every decode kernel (models/backends.py reads it)
SPLIT = 128                   # tokens of a run of the decode kernels (csrc kSplit)


_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 9
         + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
         + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_FM_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2
            + [ctypes.c_void_p])


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


def _check_cache(name, q, k_vals, k_idx, v):
    """Device, dtype and width checks shared by the token-major wrappers."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {q.device}")
    for t in (k_vals, k_idx, v):
        if t.device != q.device:
            raise ValueError(f"{name}: inputs on different devices")
    if k_vals.dtype not in _VALS or v.dtype != k_vals.dtype:
        raise TypeError(f"{name} kernel takes f32/bf16 k_vals and v of one "
                        f"dtype, got {k_vals.dtype}/{v.dtype}")
    if k_idx.dtype not in _IDX:
        raise TypeError(f"{name}: k_idx dtype {k_idx.dtype} not in {list(_IDX)}")
    kk, dv = k_vals.shape[-1], v.shape[-1]
    if k_idx.shape[-1] != kk or dv not in V_HEAD_DIMS:
        raise ValueError(f"{name}: k_idx width {k_idx.shape[-1]} vs {kk}, "
                         f"dv={dv} (kernel takes {V_HEAD_DIMS})")
    for t, what in ((k_vals, "k_vals"), (k_idx, "k_idx"), (v, "v")):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {what} needs a contiguous last axis")
    return kk, dv


def _int32(t, device, shape, name, what):
    t = torch.as_tensor(t, device=device).to(torch.int32).contiguous()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} {tuple(t.shape)}, expected {tuple(shape)}")
    return t


def _launch_token_major(name, q, k_vals, k_idx, v, lens, *, heads, hkv, d, scale,
                        n_cap, strides, bt=None, max_pages=0, page=0,
                        slot_fixed=-1, len_per_slot=0):
    """One call of ``flash_sfa_decode_launch`` (the split kernel, then the
    merge kernel) -> (rows, dv) f32."""
    rows = q.shape[0]
    kk, dv = k_vals.shape[-1], v.shape[-1]
    q = q.float().contiguous()
    out = torch.empty((rows, dv), dtype=torch.float32, device=q.device)
    # each run's partial (m, l, acc[dv]), merged in run order by the second kernel
    ws = torch.empty(rows * -(-n_cap // SPLIT) * (dv + 2), dtype=torch.float32,
                     device=q.device)
    fn = _build.entry("flash_sfa_decode", "flash_sfa_decode_launch", _ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_vals.data_ptr(), k_idx.data_ptr(), v.data_ptr(),
                 lens.data_ptr(), out.data_ptr(), ws.data_ptr(), rows, heads, hkv, kk, d,
                 dv, n_cap, SPLIT, *strides, float(scale), _VALS[v.dtype], _IDX[k_idx.dtype],
                 None if bt is None else bt.data_ptr(), max_pages, page,
                 slot_fixed, len_per_slot, _build.stream_ptr(q))
    _build.check("flash_sfa_decode", err, f"{name} launch")
    return out


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
    _check_cache("flash_sfa_decode", q, k_vals, k_idx, v)
    b, n_max, hkv, skv = _layout(k_vals, "k_vals")
    lay_i, lay_v = _layout(k_idx, "k_idx"), _layout(v, "v")
    if lay_i[:3] != (b, n_max, hkv) or lay_v[:3] != (b, n_max, hkv):
        raise ValueError("flash_sfa_decode: k_vals, k_idx and v disagree on "
                         "(batch, tokens, kv heads)")
    bh = q.shape[0]
    if q.shape != (bh, d) or bh % b or (bh // b) % hkv:
        raise ValueError(f"flash_sfa_decode: q {tuple(q.shape)} does not fit "
                         f"batch {b} x heads (multiple of {hkv}) x d {d}")
    lens = _int32(lengths, q.device, (bh,), "flash_sfa_decode", "lengths")
    out = _launch_token_major("flash_sfa_decode", q, k_vals, k_idx, v, lens,
                              heads=bh // b, hkv=hkv, d=d, scale=scale, n_cap=n_max,
                              strides=(*skv, *lay_i[3], *lay_v[3]))
    flash_sfa_decode.launches += 1
    return out


flash_sfa_decode.launches = 0


def _pool_strides(t, name, what):
    """(page, in-page token, head) strides of a (hkv, P, page, F) pool."""
    if t.ndim != 4:
        raise ValueError(f"{name}: {what} must be a (hkv, pages, page, F) pool, "
                         f"got {tuple(t.shape)}")
    return t.stride(1), t.stride(2), t.stride(0)


def _check_pools(name, kv_pool, ki_pool, v_pool, block_tables):
    hkv, pages, page = v_pool.shape[:3]
    for t in (kv_pool, ki_pool):
        if tuple(t.shape[:3]) != (hkv, pages, page):
            raise ValueError(f"{name}: pools disagree on (kv heads, pages, page)")
    if block_tables.ndim != 2 or block_tables.device != v_pool.device:
        raise ValueError(f"{name}: block_tables must be a (slots, max_pages) "
                         f"tensor on the pools' device")
    return hkv, page


def flash_sfa_decode_paged(q, kv_pool, ki_pool, v_pool, block_tables, lengths, *,
                           d: int, scale: float | None = None, heads: int = 1):
    """Token-major sparse-cache decode over a paged pool -> (slots·heads, dv)
    f32.

    q: (slots·heads, d) dense query; kv_pool/ki_pool: (hkv, P, page, k)
    (indices packed at rest); v_pool: (hkv, P, page, dv); block_tables:
    (slots, max_pages) int32; lengths: (slots,) including the just-written
    token. Token j of a slot is read at offset j % page of pool page
    ``bt[slot, j // page]``; positions past the table are never read, so a
    dead slot parked at a sentinel length reads its table's pages only.
    """
    scale = float(scale if scale is not None else d ** -0.5)
    _build.refuse_grad("flash_sfa_decode_paged", q, kv_pool, v_pool)
    if q.device.type == "cpu":
        return flash_sfa_decode_paged_ref(q, kv_pool, ki_pool, v_pool, block_tables,
                                          lengths, d=d, scale=scale, heads=heads)
    name = "flash_sfa_decode_paged"
    _check_cache(name, q, kv_pool, ki_pool, v_pool)
    hkv, page = _check_pools(name, kv_pool, ki_pool, v_pool, block_tables)
    slots, mp = block_tables.shape
    if q.shape != (slots * heads, d) or heads % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit {slots} slots x "
                         f"{heads} heads (a multiple of {hkv}) x d {d}")
    bt = _int32(block_tables, q.device, (slots, mp), name, "block_tables")
    lens = _int32(lengths, q.device, (slots,), name, "lengths")
    out = _launch_token_major(
        name, q, kv_pool, ki_pool, v_pool, lens, heads=heads, hkv=hkv, d=d,
        scale=scale, n_cap=mp * page,
        strides=(*_pool_strides(kv_pool, name, "kv_pool"),
                 *_pool_strides(ki_pool, name, "ki_pool"),
                 *_pool_strides(v_pool, name, "v_pool")),
        bt=bt, max_pages=mp, page=page, len_per_slot=1)
    flash_sfa_decode_paged.launches += 1
    return out


flash_sfa_decode_paged.launches = 0


def flash_sfa_decode_multi(q, k_vals, k_idx, v, lengths, *, d: int,
                           scale: float | None = None, heads: int = 1,
                           block_tables=None, slot: int = 0):
    """Speculative verify: C queries of one slot -> (C·heads, dv) f32.

    q: (C·heads, d) dense queries, row ``c·heads + h``; lengths: (C·heads,)
    per-row causal lengths (``cache_len + c + 1``). The cache is one slot's
    contiguous leaves (H, n_max, F), H = heads or kv heads (the JAX
    kernel's form), or, with ``block_tables`` (slots, max_pages), the pools
    (hkv, P, page, F) read in place through row ``slot``. Row c equals
    ``flash_sfa_decode_paged`` for that query at that length bit for bit.
    """
    scale = float(scale if scale is not None else d ** -0.5)
    _build.refuse_grad("flash_sfa_decode_multi", q, k_vals, v)
    if q.device.type == "cpu":
        return flash_sfa_decode_multi_ref(q, k_vals, k_idx, v, lengths, d=d,
                                          scale=scale, heads=heads,
                                          block_tables=block_tables, slot=slot)
    name = "flash_sfa_decode_multi"
    _check_cache(name, q, k_vals, k_idx, v)
    rows = q.shape[0]
    if q.shape != (rows, d) or rows % heads:
        raise ValueError(f"{name}: q {tuple(q.shape)} is not (C x {heads} heads, {d})")
    lens = _int32(lengths, q.device, (rows,), name, "lengths")
    if block_tables is not None:
        hkv, page = _check_pools(name, k_vals, k_idx, v, block_tables)
        slots, mp = block_tables.shape
        if not 0 <= slot < slots or heads % hkv:
            raise ValueError(f"{name}: slot {slot} of {slots}, heads {heads} vs "
                             f"kv heads {hkv}")
        bt = _int32(block_tables, q.device, (slots, mp), name, "block_tables")
        out = _launch_token_major(
            name, q, k_vals, k_idx, v, lens, heads=heads, hkv=hkv, d=d, scale=scale,
            n_cap=mp * page,
            strides=(*_pool_strides(k_vals, name, "k_vals"),
                     *_pool_strides(k_idx, name, "k_idx"),
                     *_pool_strides(v, name, "v")),
            bt=bt, max_pages=mp, page=page, slot_fixed=int(slot))
    else:
        if k_vals.ndim != 3 or k_idx.shape[:2] != k_vals.shape[:2] \
                or v.shape[:2] != k_vals.shape[:2]:
            raise ValueError(f"{name}: contiguous leaves must be (H, n_max, F)")
        hkv, n_max = k_vals.shape[:2]
        if heads % hkv:
            raise ValueError(f"{name}: heads {heads} vs cache heads {hkv}")
        out = _launch_token_major(
            name, q, k_vals, k_idx, v, lens, heads=heads, hkv=hkv, d=d, scale=scale,
            n_cap=n_max,
            strides=tuple(x for t in (k_vals, k_idx, v)
                          for x in (0, t.stride(1), t.stride(0))),
            slot_fixed=0)
    flash_sfa_decode_multi.launches += 1
    return out


flash_sfa_decode_multi.launches = 0


def _check_fm(name, q_vals, q_idx, k_feat, v):
    if q_vals.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {q_vals.device}")
    for t in (q_idx, k_feat, v):
        if t.device != q_vals.device:
            raise ValueError(f"{name}: inputs on different devices")
    if k_feat.dtype not in _VALS or v.dtype != k_feat.dtype:
        raise TypeError(f"{name} kernel takes f32/bf16 k_feat and v of one dtype, "
                        f"got {k_feat.dtype}/{v.dtype}")
    if q_idx.shape != q_vals.shape or q_vals.ndim != 2:
        raise ValueError(f"{name}: q_vals/q_idx must be (rows, kq) alike")
    if v.shape[-1] not in V_HEAD_DIMS:
        raise ValueError(f"{name}: dv={v.shape[-1]} (kernel takes {V_HEAD_DIMS})")
    for t, what in ((k_feat, "k_feat"), (v, "v")):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {what} needs a contiguous last axis")


def _launch_fm(name, q_vals, q_idx, k_feat, v, lens, *, heads, group, d, scale,
               n_cap, strides, bt=None, max_pages=0, page=0):
    """One call of ``flash_sfa_decode_fm_launch`` (the split kernel, then the
    merge kernel) -> (rows, dv) f32."""
    rows, kq = q_vals.shape
    dv = v.shape[-1]
    qv = q_vals.float().contiguous()
    qi = q_idx.to(torch.int32).contiguous()
    out = torch.empty((rows, dv), dtype=torch.float32, device=qv.device)
    # each run's partial (m, l, acc[dv]), merged in run order by the second kernel
    ws = torch.empty(rows * -(-n_cap // SPLIT) * (dv + 2), dtype=torch.float32,
                     device=qv.device)
    fn = _build.entry("flash_sfa_decode_fm", "flash_sfa_decode_fm_launch", _FM_ARGS)
    with torch.cuda.device(qv.device):
        err = fn(qv.data_ptr(), qi.data_ptr(), k_feat.data_ptr(), v.data_ptr(),
                 lens.data_ptr(), out.data_ptr(), ws.data_ptr(), rows, heads, group, kq,
                 d, dv, n_cap, SPLIT, *strides, float(scale), _VALS[v.dtype],
                 None if bt is None else bt.data_ptr(), max_pages, page,
                 _build.stream_ptr(qv))
    _build.check("flash_sfa_decode_fm", err, f"{name} launch")
    return out


def flash_sfa_decode_fm(q_vals, q_idx, k_feat, v, lengths, *,
                        scale: float | None = None, group: int = 1):
    """Feature-major decode: the sparse query reads k feature rows of the
    dense image -> (bh, dv) f32.

    q_vals/q_idx: (bh, kq); k_feat: (bh // group, d, n_max); v:
    (bh // group, n_max, dv); lengths: (bh,). Row i reads image and V row
    i // group (one persistent image serves a GQA group).
    """
    d, n_max = k_feat.shape[-2:]
    scale = float(scale if scale is not None else d ** -0.5)
    _build.refuse_grad("flash_sfa_decode_fm", q_vals, k_feat, v)
    if q_vals.device.type == "cpu":
        return flash_sfa_decode_fm_ref(q_vals, q_idx, k_feat, v, lengths,
                                       scale=scale, group=group)
    name = "flash_sfa_decode_fm"
    _check_fm(name, q_vals, q_idx, k_feat, v)
    rows = q_vals.shape[0]
    if (k_feat.ndim != 3 or rows != k_feat.shape[0] * group
            or tuple(v.shape[:2]) != (k_feat.shape[0], n_max)):
        raise ValueError(f"{name}: k_feat {tuple(k_feat.shape)}, v {tuple(v.shape)} "
                         f"do not fit {rows} rows in groups of {group}")
    lens = _int32(lengths, q_vals.device, (rows,), name, "lengths")
    out = _launch_fm(name, q_vals, q_idx, k_feat, v, lens, heads=rows, group=group,
                     d=d, scale=scale, n_cap=n_max,
                     strides=(k_feat.stride(0), 0, k_feat.stride(1),
                              v.stride(0), 0, v.stride(1)))
    flash_sfa_decode_fm.launches += 1
    return out


flash_sfa_decode_fm.launches = 0


def flash_sfa_decode_fm_paged(q_vals, q_idx, kf_pool, v_pool, block_tables, lengths,
                              *, scale: float | None = None, heads: int = 1):
    """Feature-major decode over a paged image pool -> (slots·heads, dv) f32.

    q_vals/q_idx: (slots·heads, kq); kf_pool: (hkv, P, d, page), each pool
    page a (d, page) tile of the image; v_pool: (hkv, P, page, dv);
    block_tables: (slots, max_pages) int32; lengths: (slots,). Equal to
    ``flash_sfa_decode_fm`` on the gathered image bit for bit.
    """
    hkv, pages, d, page = kf_pool.shape
    scale = float(scale if scale is not None else d ** -0.5)
    _build.refuse_grad("flash_sfa_decode_fm_paged", q_vals, kf_pool, v_pool)
    if q_vals.device.type == "cpu":
        return flash_sfa_decode_fm_paged_ref(q_vals, q_idx, kf_pool, v_pool,
                                             block_tables, lengths, scale=scale,
                                             heads=heads)
    name = "flash_sfa_decode_fm_paged"
    _check_fm(name, q_vals, q_idx, kf_pool, v_pool)
    if tuple(v_pool.shape[:3]) != (hkv, pages, page) or block_tables.ndim != 2:
        raise ValueError(f"{name}: kf_pool {tuple(kf_pool.shape)}, v_pool "
                         f"{tuple(v_pool.shape)}, block_tables "
                         f"{tuple(block_tables.shape)} disagree")
    slots, mp = block_tables.shape
    if q_vals.shape[0] != slots * heads or heads % hkv:
        raise ValueError(f"{name}: {q_vals.shape[0]} query rows for {slots} slots x "
                         f"{heads} heads (a multiple of {hkv})")
    bt = _int32(block_tables, q_vals.device, (slots, mp), name, "block_tables")
    lens = _int32(lengths, q_vals.device, (slots,), name, "lengths")
    out = _launch_fm(name, q_vals, q_idx, kf_pool, v_pool, lens, heads=heads,
                     group=heads // hkv, d=d, scale=scale, n_cap=mp * page,
                     strides=(kf_pool.stride(0), kf_pool.stride(1), kf_pool.stride(2),
                              v_pool.stride(0), v_pool.stride(1), v_pool.stride(2)),
                     bt=bt, max_pages=mp, page=page)
    flash_sfa_decode_fm_paged.launches += 1
    return out


flash_sfa_decode_fm_paged.launches = 0


def feature_major_prefill(k_vals, k_idx, d: int):
    """The persistent ``FeatureMajorKV`` image of a prefill's K codes:
    k_vals/k_idx (b, n, hkv, k) -> (b, hkv, d, n), a torch scatter (the
    JAX package's ``feature_major_prefill`` is an XLA scatter, not a
    kernel). Runs once per prompt; decode then extends the image one
    column per token."""
    return to_feature_major(SparseCode(values=k_vals.movedim(1, 2),
                                       indices=k_idx.movedim(1, 2).long(), dim=d))
