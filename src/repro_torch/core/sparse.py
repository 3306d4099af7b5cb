"""Sparse feature codes — the paper's core data structure (plain PyTorch).

Fixed-k token-major form, as in the JAX package's ``repro/core/sparse.py``:
``values (..., k)`` + ``indices (..., k)`` (int64 in compute here, int32 in
the kernels; the at-rest KV cache packs indices to uint8/uint16 — see
``core/kv_cache.py``). Indices ascend per row and ties keep the lowest
index, so the codes are bit-for-bit those of the JAX package.

These functions are the plain oracle (the ``"torch"`` backend). ``topk_mask``
is the reference's selection in the reference's form (a 32-step bisection,
some 200 small launches a call); ``sparsify`` and ``topk_st`` make that
same selection with ``topk_select``'s one keyed ``torch.topk``, which keeps
the oracle's layers (windows, protected RoPE dims, MLA) from being bound by
launches. On the card the kernel paths make their codes with the rtopk
kernel instead (``kernels/ops.py``), under the same contract on NaN-free
rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SparseCode(NamedTuple):
    """Fixed-k sparse rows of a (..., d) tensor.

    values:  (..., k)  original entries at the top-k |.| coordinates
    indices: (..., k)  coordinate ids, ascending per row (deterministic)
    dim:     d, the dense feature dimension
    """

    values: torch.Tensor
    indices: torch.Tensor
    dim: int

    @property
    def k(self) -> int:
        return self.values.shape[-1]


# above the bit pattern of +inf: no finite magnitude counts as >= it
_BISECT_HI = 0x7F800001


def bisect_threshold(bits: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest of non-negative int32 float bit patterns, per row.

    The 32-step integer bisection of the paper's RTopK idea, made exact on
    IEEE-754 bit patterns: for non-negative floats the int32 pattern is
    order-isomorphic to the value. Returns ``(..., 1)`` int32 thresholds
    with ``count(bits >= theta) >= k`` and ``count(bits > theta) < k``.
    """
    lo = torch.zeros(bits.shape[:-1] + (1,), dtype=torch.int32,
                     device=bits.device)
    hi = torch.full_like(lo, _BISECT_HI)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        cnt = (bits >= mid).sum(-1, keepdim=True)
        take_lo = cnt >= k
        lo = torch.where(take_lo, mid, lo)
        hi = torch.where(take_lo, hi, mid)
    return lo


def select_mask(bits: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k selection mask on bit patterns: everything strictly above the
    threshold, then ties in ascending index order until k are kept."""
    theta = bisect_threshold(bits, k)
    sel_hi = bits > theta
    sel_tie = bits == theta
    n_hi = sel_hi.sum(-1, keepdim=True)
    rank_tie = torch.cumsum(sel_tie.to(torch.int32), dim=-1)
    return sel_hi | (sel_tie & (rank_tie <= (k - n_hi)))


def magnitude_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns of |x| in float32 (order-isomorphic to |x|)."""
    return x.float().abs().view(torch.int32)


def topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask selecting the k largest-|x| coords per row (Eq. 4).

    Same bisection as the JAX package's ``topk_mask`` (core/sparse.py:36-64),
    not ``torch.topk``, which promises neither its output order nor how it
    breaks ties. The lowest index wins a tie.
    """
    d = x.shape[-1]
    if k >= d:
        return torch.ones_like(x, dtype=torch.bool)
    return select_mask(magnitude_bits(x), k)


def topk_select(x: torch.Tensor, k: int):
    """``topk_mask``'s selection as (mask, the k indices ascending), in one
    ``torch.topk`` on keys that hold each |x|'s bit pattern above its
    reversed index: no two keys of a row are equal, so the top k keys are
    that selection whatever order topk breaks ties in. The fast form of
    ``topk_mask``, whose 32-step bisection costs some 200 small launches a
    call; ``topk_mask`` stays the plain reference."""
    d = x.shape[-1]
    shift = max(1, (d - 1).bit_length())
    rev = d - 1 - torch.arange(d, device=x.device)
    keys = (magnitude_bits(x).long() << shift) | rev
    idx = keys.topk(min(k, d), dim=-1).indices.sort(dim=-1).values
    mask = torch.zeros_like(x, dtype=torch.bool).scatter_(-1, idx, True)
    return mask, idx


def mask_to_indices(mask: torch.Tensor, k: int) -> torch.Tensor:
    """(..., d) mask with exactly k set per row -> (..., k) int64 ascending
    indices (``nonzero`` walks in row-major order)."""
    lead = mask.shape[:-1]
    cols = mask.reshape(-1, mask.shape[-1]).nonzero()[:, 1]
    return cols.reshape(lead + (k,))


def sparsify(x: torch.Tensor, k: int) -> SparseCode:
    """Row-wise Top-k by magnitude, keeping original values (Eq. 3-4).
    Indices come out ascending."""
    d = x.shape[-1]
    _, idx = topk_select(x, min(k, d))
    return SparseCode(values=x.gather(-1, idx), indices=idx, dim=d)


def sub_k(values: torch.Tensor, indices: torch.Tensor, k_draft: int):
    """Re-threshold a stored top-k code to its top-k' (k' < k) sub-code.

    ``topk_mask`` selects by a global magnitude threshold with the lowest
    index winning a tie, so the top-k' entries of the stored k entries are
    the global top-k' of the original row (the nested-k property the
    speculative draft relies on). Positions within the width-k code are
    taken in ascending order, and stored indices ascend per row, so the
    sub-code's indices ascend too: the order every decode kernel relies on.
    Same values, indices and tie-breaks as the JAX package's ``sub_k``
    (core/sparse.py:100). Returns ``(values', indices') (..., k_draft)``.
    """
    k = values.shape[-1]
    if k_draft >= k:
        return values, indices
    pos = mask_to_indices(topk_mask(values, k_draft), k_draft)
    return values.gather(-1, pos), indices.gather(-1, pos)


def densify(code: SparseCode) -> torch.Tensor:
    """Scatter a SparseCode back to its dense (..., d) form. Duplicate
    indices sum, as the JAX one-hot contraction does."""
    vals = code.values
    out = torch.zeros(vals.shape[:-1] + (code.dim,), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_add_(-1, code.indices.long(), vals)


def topk_st(x: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k by magnitude with the other coordinates zeroed (paper Eq. 6).

    The mask is a constant of the product, so autograd gives the
    straight-through gradient of Eq. 6 as it is: the incoming gradient on
    the k selected coordinates and zero elsewhere (``topk_st`` of the JAX
    package, core/sparse.py:139), with ``topk_mask``'s selection."""
    return x * topk_select(x, k)[0].to(x.dtype)


def to_feature_major(code: SparseCode) -> torch.Tensor:
    """Dense feature-major ``(..., d, n)`` image of token-major codes
    ``(..., n, k)``: the layout in which a k-sparse query reads only its k
    feature rows (the JAX package's ``to_feature_major``)."""
    return densify(code).transpose(-1, -2)
