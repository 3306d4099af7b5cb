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
    ties keep the lowest index, and values are moved bit-exact.
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
        nq, nk = s.shape[-2], s.shape[-1]
        ok = (torch.arange(nk, device=s.device)[None, :]
              <= torch.arange(nq, device=s.device)[:, None])
        s = torch.where(ok[None], s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bqk,bkd->bqd", p, v.float()).to(v.dtype)
    return (out, lse) if return_residuals else out


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
    ``decode_cache_views``; any index dtype. -> (bh, dv) f32."""
    scale = scale if scale is not None else d ** -0.5
    kv, ki, vv = decode_cache_views(q, k_vals, k_idx, v)
    kd = _densify(kv, ki, d)                                # (bh, n, d)
    s = torch.einsum("bd,bnd->bn", q.float(), kd) * scale
    n = kv.shape[1]
    lengths = torch.as_tensor(lengths, device=q.device).reshape(-1, 1)
    valid = torch.arange(n, device=q.device)[None, :] < lengths
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bn,bnd->bd", p, vv.float())
