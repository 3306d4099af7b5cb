"""Plain PyTorch versions of the port's kernels.

Each ``<kernel>_ref`` computes what its CUDA kernel computes, in ordinary
torch ops, and is what the kernel's wrapper runs for a tensor on the CPU. On
the card ``chip_smoke.py`` holds each kernel against it on the same inputs.
Counterpart of the JAX package's ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse import magnitude_bits, mask_to_indices, select_mask

NEG_INF = -1e30


def rtopk_ref(x: torch.Tensor, k: int):
    """Row-wise exact top-|k|: x (..., d) -> (values (..., k) in x.dtype,
    indices (..., k) int32 ascending).

    The 32-step bisection on the bit patterns of |x| (the form of
    ``core.sparse.topk_mask``), not ``torch.topk``. NaN is canonicalized to
    +0 first (the rtopk contract: parity with top-k of |nan_to_zero(x)|),
    ties keep the lowest index, and values are moved bit-exact. The CUDA
    kernel (``csrc/rtopk.cu``, its selection in ``csrc/topk_select.cuh``)
    makes the same choice two other ways: one thread a row keeping the k
    largest magnitudes in a register list (d 32, 64 or 128, k <= 16), or
    one warp a row bisecting over the raw bits (16 steps for bf16).
    """
    d = x.shape[-1]
    if not 0 < k <= d:
        raise ValueError(f"rtopk needs 0 < k <= d, got k={k}, d={d}")
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    idx = mask_to_indices(select_mask(magnitude_bits(x), k), k)
    return x.gather(-1, idx), idx.to(torch.int32)


def _densify(vals, idx, d):
    """(..., k) codes -> (..., d) f32, duplicates summing; indices outside
    [0, d) contribute nothing (as ``jax.nn.one_hot`` gives a zero row)."""
    vals = vals.float()
    idx = idx.long()
    ok = (idx >= 0) & (idx < d)
    out = torch.zeros(vals.shape[:-1] + (d,), dtype=torch.float32,
                      device=vals.device)
    return out.scatter_add_(-1, torch.where(ok, idx, 0),
                            torch.where(ok, vals, 0.0))


def flash_sfa_ref(q_vals, q_idx, k_vals, k_idx, v, *, d: int,
                  causal: bool = True, scale: float | None = None,
                  return_residuals: bool = False):
    """FlashSFA prefill: codes (bh, n, k), v (bh, nk, dv) -> (bh, nq, dv)
    in v.dtype = softmax(densify(Q̃)·densify(K̃)ᵀ·scale + causal)·V, in f32.
    With ``return_residuals`` also the per-row LSE (bh, nq) f32."""
    scale = scale if scale is not None else d ** -0.5
    qd = _densify(q_vals, q_idx, d)
    kd = _densify(k_vals, k_idx, d)
    s = torch.einsum("bqd,bkd->bqk", qd, kd) * scale
    if causal:
        ok = _causal_ok(s.shape[-2], s.shape[-1], s.device)
        s = torch.where(ok[None], s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bqk,bkd->bqd", p, v.float()).to(v.dtype)
    return (out, lse) if return_residuals else out


def _causal_ok(nq, nk, device):
    """(nq, nk) bool: key j visible to query i (j <= i)."""
    return (torch.arange(nk, device=device)[None, :]
            <= torch.arange(nq, device=device)[:, None])


def _support(idx, d):
    """(..., k) indices -> (..., d) f32 {0, 1} mask of the stored
    coordinates (``_support_mask`` of the JAX backward); indices outside
    [0, d) mark nothing."""
    idx = idx.long()
    ok = (idx >= 0) & (idx < d)
    out = torch.zeros(idx.shape[:-1] + (d,), dtype=torch.float32,
                      device=idx.device)
    return out.scatter_add_(-1, torch.where(ok, idx, 0), ok.float()).clamp_(max=1.0)


def _attention_bwd(q, k, v, o, lse, g, *, causal, scale):
    """Shared backward math on f32 (bh, n, d) q/k: recompute P from the
    LSE, dS = P·(dO·Vᵀ − D)·scale with D = Σ(dO ∘ O), then dQ = dS·K,
    dK = dSᵀ·Q and dV = Pᵀ·dO, all f32."""
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    if causal:
        ok = _causal_ok(s.shape[-2], s.shape[-1], s.device)[None]
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(ok, p, torch.zeros_like(p))
    gf = g.float()
    dp = torch.einsum("bqe,bke->bqk", gf, v.float())
    delta = (gf * o.float()).sum(-1)
    ds = p * (dp - delta[..., None]) * scale
    return (torch.einsum("bqk,bkd->bqd", ds, k),
            torch.einsum("bqk,bqd->bkd", ds, q),
            torch.einsum("bqk,bqe->bke", p, gf))


def gather_support(acc, idx):
    """(..., d) dense rows -> (..., k) their values at the stored
    coordinates (``_gather_support`` of the JAX backward): a duplicate
    index gathers the full value once per copy, and an index outside
    [0, d) gathers 0."""
    d = acc.shape[-1]
    idx = idx.long()
    ok = (idx >= 0) & (idx < d)
    got = acc.gather(-1, torch.where(ok, idx, 0))
    return torch.where(ok, got, torch.zeros_like(got))


def pair_closure_gather(acc, idx, rot_dim: int):
    """(..., d) dense rows -> (..., 2k) values on the RoPE pair closure
    (``_pair_closure_gather``): each stored value lands in the even half if
    its index is even or unrotated (>= rot_dim), in the odd half if it is
    odd and rotated; the partner slot is 0."""
    g = gather_support(acc, idx)
    odd = ((idx.long() < rot_dim) & (idx.long() % 2 == 1)).to(g.dtype)
    return torch.cat([g * (1.0 - odd), g * odd], dim=-1)


def flash_sfa_bwd_ref(q_vals, q_idx, k_vals, k_idx, v, o, lse, g, *, d: int,
                      causal: bool = True, scale: float | None = None,
                      emit: str = "dense", rot_dim: int | None = None):
    """FlashSFA backward: codes (bh, n, k), v/o/g (bh, n, dv), lse (bh, n)
    f32 -> dQ, dK in the code values' dtypes and dV (bh, n, dv) in v.dtype.
    Densify, recompute P from the LSE, dS, dQ/dK/dV in f32, then emit dQ/dK
    as ``emit`` says: "dense" (bh, n, d) rows, zero off each row's stored
    coordinates (paper Eq. 6's straight-through gradient); "compact"
    (bh, n, k) values aligned to the stored indices; "compact2" (bh, n, 2k)
    values on the RoPE pair closure of the stored indices (``rot_dim``,
    default d, bounds the rotated dims)."""
    scale = scale if scale is not None else d ** -0.5
    qd = _densify(q_vals, q_idx, d)
    kd = _densify(k_vals, k_idx, d)
    dq, dk, dv = _attention_bwd(qd, kd, v, o, lse, g, causal=causal, scale=scale)
    if emit == "dense":
        dq, dk = dq * _support(q_idx, d), dk * _support(k_idx, d)
    elif emit == "compact":
        dq, dk = gather_support(dq, q_idx), gather_support(dk, k_idx)
    elif emit == "compact2":
        rot = d if rot_dim is None else rot_dim
        dq, dk = pair_closure_gather(dq, q_idx, rot), pair_closure_gather(dk, k_idx, rot)
    else:
        raise ValueError(f"emit={emit!r}; expected 'dense', 'compact' or 'compact2'")
    return dq.to(q_vals.dtype), dk.to(k_vals.dtype), dv.to(v.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        scale: float | None = None,
                        return_residuals: bool = False):
    """Dense attention: q/k (bh, n, d), v (bh, nk, dv) -> (bh, nq, dv) in
    v.dtype = softmax(Q·Kᵀ·scale + causal)·V in f32; with
    ``return_residuals`` also the per-row LSE (bh, nq) f32."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        ok = _causal_ok(s.shape[-2], s.shape[-1], s.device)[None]
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bqk,bkd->bqd", p, v.float()).to(v.dtype)
    return (out, lse) if return_residuals else out


def flash_attention_bwd_ref(q, k, v, o, lse, g, *, causal: bool = True,
                            scale: float | None = None):
    """Dense attention backward: q/k/v/o/g (bh, n, d), lse (bh, n) f32 ->
    dQ, dK, dV in q's, k's and v's dtypes."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    dq, dk, dv = _attention_bwd(q.float(), k.float(), v, o, lse, g,
                                causal=causal, scale=scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_cache_views(q, k_vals, k_idx, v):
    """Cache leaves as (bh, n, F) per query row, GQA-expanded.

    Takes the JAX kernel's folded (bh, n, F) layout as it is, or the
    ``SparseKV`` layout (b, n, hkv, F) with ``q.shape[0] = b·h``: query row
    ``b·h + j`` reads kv head ``j // (h // hkv)``.
    """
    if k_vals.ndim == 3:
        return k_vals, k_idx, v
    b, n, hkv = k_vals.shape[:3]
    h = q.shape[0] // b

    def fold(t):
        t = t.repeat_interleave(h // hkv, dim=2)           # (b, n, h, F)
        return t.permute(0, 2, 1, 3).reshape(b * h, n, t.shape[-1])

    return fold(k_vals), fold(k_idx), fold(v)


def flash_sfa_decode_ref(q, k_vals, k_idx, v, lengths, *, d: int,
                         scale: float | None = None):
    """Decode: dense query (bh, d) against a token-major sparse K cache and
    dense V, masked to ``lengths (bh,)``. Cache leaves as in
    ``decode_cache_views``; any index dtype. -> (bh, dv) f32; a row of
    length 0 has no key and gives 0, as the kernels' acc / max(l, 1e-30).

    Replaces ``repro/kernels/flash_sfa_decode.py::flash_sfa_decode`` (row
    10). The kernel is bound by bytes (each valid token's k codes and V row
    read once); its design splits every row into runs of 128 positions, one
    block each, so the card keeps enough loads in flight, and merges the
    runs' partials in run order (``csrc/flash_sfa_decode.cu``).
    """
    scale = scale if scale is not None else d ** -0.5
    kv, ki, vv = decode_cache_views(q, k_vals, k_idx, v)
    kd = _densify(kv, ki, d)                                # (bh, n, d)
    s = torch.einsum("bd,bnd->bn", q.float(), kd) * scale
    n = kv.shape[1]
    lengths = torch.as_tensor(lengths, device=q.device).reshape(-1, 1)
    valid = torch.arange(n, device=q.device)[None, :] < lengths
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.where(lengths > 0, torch.einsum("bn,bnd->bd", p, vv.float()), 0.0)


def _pool_view(pool, bt):
    """(hkv, P, page, F) pool -> (s, n, hkv, F) token-major view of the
    block tables ``bt (s, max_pages)``, n = max_pages·page."""
    g = pool[:, bt.long()]                                  # (hkv, s, mp, page, F)
    hkv, s, mp, page = g.shape[:4]
    return g.reshape(hkv, s, mp * page, g.shape[-1]).permute(1, 2, 0, 3)


def flash_sfa_decode_paged_ref(q, kv_pool, ki_pool, v_pool, block_tables,
                               lengths, *, d: int, scale: float | None = None,
                               heads: int = 1):
    """Decode over a paged token-major pool: q (slots·heads, d); pools
    (hkv, P, page, F); block_tables (slots, max_pages); lengths (slots,)
    including the new token. -> (slots·heads, dv) f32.

    Replaces ``repro/kernels/flash_sfa_decode.py::flash_sfa_decode_paged``
    (row 11 of PERF.md). The plain version gathers the block-table view
    and runs ``flash_sfa_decode_ref`` on it, which is what the kernel must
    equal bit for bit on the card. The kernel is bound by bytes (it reads
    each valid token's k codes and V row once); its design is row 10's
    split body reading the pools in place through the block table (each
    run's pages looked up once), with no gather, unpack, GQA repeat or
    upcast copy.
    """
    view = [_pool_view(t, block_tables) for t in (kv_pool, ki_pool, v_pool)]
    lens = torch.as_tensor(lengths, device=q.device).reshape(-1).repeat_interleave(heads)
    return flash_sfa_decode_ref(q, *view, lens, d=d, scale=scale)


def flash_sfa_decode_multi_ref(q, k_vals, k_idx, v, lengths, *, d: int,
                               scale: float | None = None, heads: int = 1,
                               block_tables=None, slot: int = 0):
    """Speculative verify: C queries q (C·heads, d) of one slot, row
    ``c·heads + h`` masked to its own ``lengths[c·heads + h]``. The cache is
    one slot's contiguous leaves (H, n, F) with H = heads or kv heads (the
    JAX kernel's form), or, with ``block_tables``, the pools (hkv, P, page,
    F) read through row ``slot`` of the table. -> (C·heads, dv) f32.

    Replaces ``repro/kernels/flash_sfa_decode.py::flash_sfa_decode_multi``
    (row 12). Bound by bytes: the least the card must move is the slot's
    cache once for all C queries. The kernel splits and sums every row
    exactly as the paged decode kernel does (runs by position, merged in
    run order), so row c equals a paged decode at its length bit for bit
    (the greedy acceptance rule compares argmaxes across them); it still
    reads the slot's cache once per query row.
    """
    if block_tables is not None:
        bt = block_tables[int(slot)][None]
        k_vals, k_idx, v = (_pool_view(t, bt)[0].transpose(0, 1)
                            for t in (k_vals, k_idx, v))      # (hkv, n, F)
    c = q.shape[0] // heads

    def per_query(t):                                       # (H, n, F) -> (C, n, H, F)
        return t.transpose(0, 1)[None].expand(c, *t.transpose(0, 1).shape)

    return flash_sfa_decode_ref(q, per_query(k_vals), per_query(k_idx), per_query(v),
                                lengths, d=d, scale=scale)


def flash_sfa_decode_fm_ref(q_vals, q_idx, k_feat, v, lengths, *,
                            scale: float | None = None, group: int = 1):
    """Feature-major decode: sparse query (bh, kq) values + indices against
    the dense image k_feat (bh / group, d, n) and V (bh / group, n, dv);
    row i reads image and V row i // group; lengths (bh,). -> (bh, dv) f32;
    a row of length 0 has no key and gives 0, as the kernels' acc /
    max(l, 1e-30).

    Replaces ``repro/kernels/flash_sfa_decode.py::flash_sfa_decode_fm``
    (row 13). s_j = scale·Σ_t qv[t]·k_feat[qi[t], j]: the kernel reads only
    the kq addressed feature rows of the image, so it is bound by bytes at
    len·(kq·val + dv·val) per row. Its design splits every row into runs of
    128 positions, one block each, threads owning tokens (each feature row
    one coalesced read), and merges the runs' partials in run order
    (``csrc/flash_sfa_decode_fm.cu``).
    """
    d, n = k_feat.shape[-2:]
    scale = scale if scale is not None else d ** -0.5
    qd = _densify(q_vals, q_idx, d)                         # (bh, d)
    kf = k_feat.float().repeat_interleave(group, dim=0)     # (bh, d, n)
    s = torch.einsum("bd,bdn->bn", qd, kf) * scale
    lengths = torch.as_tensor(lengths, device=qd.device).reshape(-1, 1)
    valid = torch.arange(n, device=qd.device)[None, :] < lengths
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bn,bnd->bd", p, v.float().repeat_interleave(group, dim=0))
    return torch.where(lengths > 0, out, 0.0)


def flash_sfa_decode_fm_paged_ref(q_vals, q_idx, kf_pool, v_pool, block_tables,
                                  lengths, *, scale: float | None = None,
                                  heads: int = 1):
    """Feature-major decode over a paged image pool: q (slots·heads, kq);
    kf_pool (hkv, P, d, page); v_pool (hkv, P, page, dv); block_tables
    (slots, max_pages); lengths (slots,). -> (slots·heads, dv) f32.

    Replaces ``repro/kernels/flash_sfa_decode.py::flash_sfa_decode_fm_paged``
    (row 14): ``flash_sfa_decode_fm_ref`` on the gathered image, which the
    kernel equals bit for bit on the card. Bound by bytes like row 13; the
    kernel reads the pool in place through the block table.
    """
    bt = block_tables.long()
    g = kf_pool[:, bt]                                      # (hkv, s, mp, d, page)
    hkv, s_, mp, d, page = g.shape
    kf = g.permute(1, 0, 3, 2, 4).reshape(s_ * hkv, d, mp * page)
    gv = v_pool[:, bt]                                      # (hkv, s, mp, page, dv)
    vv = gv.transpose(0, 1).reshape(s_ * hkv, mp * page, gv.shape[-1])
    lens = torch.as_tensor(lengths, device=q_vals.device).reshape(-1).repeat_interleave(heads)
    return flash_sfa_decode_fm_ref(q_vals, q_idx, kf, vv, lens, scale=scale,
                                   group=heads // hkv)


def scatter_code_grads(vals, idx, d: int):
    """(..., k) code values -> their dense (..., d) rows in vals.dtype: the
    exact inverse of the compact emit's gather. Duplicate indices sum (pair
    closures repeat an index, each copy carrying its own share) and indices
    outside [0, d) add nothing, as the JAX one-hot contraction does."""
    return _densify(vals, idx, d).to(vals.dtype)


def code_grad_dx_ref(vals, idx, w, *, d: int):
    """dx = Σ_h scatter(vals_h, idx_h) @ w_hᵀ: codes (H, n, kw) at any code
    width, w (H, m, d) per-head weight blocks -> (n, m) f32."""
    s = _densify(vals, idx, d)                              # (H, n, d)
    return torch.einsum("hnd,hmd->nm", s, w.float())


def code_grad_dw_ref(x, vals, idx, *, d: int):
    """dW_h = xᵀ @ scatter(vals_h, idx_h): x (n, m), codes (H, n, kw) ->
    (H, m, d) f32."""
    s = _densify(vals, idx, d)                              # (H, n, d)
    return torch.einsum("nm,hnd->hmd", x.float(), s)


def rope_freqs(theta: float, rot_dim: int, device=None):
    """RoPE's pair frequencies theta^(-2j / rot_dim), j < rot_dim / 2, f32:
    the table ``models.layers.rope`` turns by and the one the proj_rtopk
    kernels read, so both carry the same bits on one device."""
    return theta ** (-torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim)


def proj_rtopk_ref(x, w_heads, positions=None, *, k: int, rope_spec=None):
    """Fused head projection -> [RoPE] -> top-k: x (b, n, m), w_heads
    (H, m, d) -> (values (b, H, n, k) in x.dtype, int32 indices ascending).

    y_h = x @ w_h with w rounded to x.dtype and the sum in f32, rounded to
    x.dtype (the unfused ``x @ w.astype(x.dtype)``); then, when
    ``rope_spec = (theta, rot_dim)``, RoPE at ``positions`` (b, n); then
    ``rtopk_ref`` on each row, with its tie order and NaN rule."""
    dt = x.dtype
    y = torch.einsum("bnm,hmd->bnhd", x.float(), w_heads.to(dt).float()).to(dt)
    if rope_spec is not None:
        if positions is None:
            raise ValueError("proj_rtopk: rope_spec needs positions")
        from repro_torch.models.layers import rope     # models import kernels
        theta, rot = rope_spec
        pos = torch.as_tensor(positions, device=x.device).expand(x.shape[0], x.shape[1])
        y = rope(y, pos, theta=theta, rot_dim=rot)
    return rtopk_ref(y.transpose(1, 2), k)
